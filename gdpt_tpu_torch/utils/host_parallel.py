"""Host-side parallel_for for scene preparation; a copy of
gdpt_tpu/utils/host_parallel.py.

The reference's pbrt-style work-stealing thread pool
(reference: src/parallel.cpp) parallelized per-tile rendering; here the
device owns rendering, so the only remaining host parallelism is scene
prep (mesh loading, texture decoding, mip building). This is a thin
thread-pool wrapper with the same chunked 1D/2D API shape.
"""

import os
from concurrent.futures import ThreadPoolExecutor

_MAX_WORKERS = max(os.cpu_count() or 1, 1)


def parallel_for(func, count, chunk_size=1, num_workers=None):
    """func(i) for i in range(count), chunked across a thread pool
    (API mirror of reference: src/parallel.h:12)."""
    workers = num_workers or _MAX_WORKERS
    if count <= 1 or workers <= 1:
        for i in range(count):
            func(i)
        return

    def run_chunk(lo):
        for i in range(lo, min(lo + chunk_size, count)):
            func(i)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(run_chunk, range(0, count, chunk_size)))


def parallel_for_2d(func, nx, ny, num_workers=None):
    """func((x, y)) over a 2D grid (API mirror of reference: src/parallel.h:13)."""
    parallel_for(lambda i: func((i % nx, i // nx)), nx * ny, num_workers=num_workers)


def parallel_map(func, items, num_workers=None):
    """Ordered parallel map for loader fan-out (e.g. submeshes of a
    .serialized file)."""
    workers = num_workers or _MAX_WORKERS
    if len(items) <= 1 or workers <= 1:
        return [func(x) for x in items]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(func, items))
