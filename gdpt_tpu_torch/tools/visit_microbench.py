"""Per-visit-type cost microbenchmark of the packet-table walk (K5).

Counterpart of tools/visit_microbench.py (`build`, `main`): times the
walk's visit bodies — the supernode slab test and the leaf primitive
tests, solo, paired as the reference's dual walk runs them, two-row as
the 32-wide table has them, and with scalar loads — in isolation over the real table,
with no walk around them, so a walk's time per visit splits into the
visit bodies and everything else (divergence, scattered rows, the
dependent child-ref loads). The hand-written Hopper kernel lives in
csrc/visit_microbench.cu: a block stages each iteration's rows once in
shared memory by bulk asynchronous copies, ahead of use, and each thread
runs four rays against every row word it reads (the walks K3 and K4
visit a row with a group of lanes, csrc/packet_group.cuh); it returns
the plain version's bits. `visit_microbench` takes its plain PyTorch
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. LAUNCHES counts kernel launches, by mode.

Contract: flat (N,) float32 ray arrays and a packet table. Every ray
visits the same pseudo-random row in the same iteration (the reference's
sequence, `row_sequence`), as what the mode says whatever the row holds.
Returns (t, prim, word): leaf modes fold hits into (t, prim) (closest
hit, every slot with id >= 0, no sphere branch); super modes OR each
visit's child mask, cut to the row's valid bits, into the per-ray int32
`word`. Pair modes (super2, super_leaf, leaf2) make two visits per
iteration and run n_visits // 2 iterations.

On the card:
    python -m gdpt_tpu_torch.tools.visit_microbench [n_rays] [n_visits] [modes]
builds the icosphere box (409,612 triangles) and its 32- and 16-wide
tables in code and prints, per table and mode, ms per launch, ns per
visit per ray and the excess over `empty`, from CUDA events.
"""

import ctypes
import sys

import numpy as np
import torch

from gdpt_tpu_torch.accel import native_build
from gdpt_tpu_torch.accel import packet_kernels as pk
from gdpt_tpu_torch.core.dtypes import INT, REAL
from gdpt_tpu_torch.utils import profiling

SOURCE = "visit_microbench.cu"
# In the order of the kernel's Mode enum.
MODES = ("empty", "super", "super_sld", "super2", "super32", "super_leaf",
         "leaf", "leaf_sld", "leaf2", "leaf24")
LAUNCHES = profiling.counter_group("visit_microbench.launches", dict.fromkeys(MODES, 0))
PAIR_MODES = ("super2", "super_leaf", "leaf2")
# Operations per ray of one iteration's slab tests (25 each); a leaf slot
# with id >= 0 adds 52 (Moeller-Trumbore).
_OPS_PER_BOX = 25
_OPS_PER_PRIM = 52
_BOXES = {"super": 16, "super_sld": 16, "super2": 32, "super32": 32, "super_leaf": 16}

_lib = None
_M32 = 0xFFFFFFFF


def _load():
    global _lib
    if _lib is None:
        lib = native_build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdpt_visit_microbench.argtypes = [p, i, i, i, p, p, p, p, p, p, p, p, i, p, p, p, p]
        lib.gdpt_visit_microbench.restype = i
        _lib = lib
    return _lib


def n_iterations(n_visits, mode):
    return n_visits // 2 if mode in PAIR_MODES else n_visits


def row_sequence(n_iters, n_rows):
    """The rows visited in iterations 0..n_iters-1, as the reference
    computes them in wrapping int32 arithmetic: (row, row2) int64 numpy
    arrays, row = ((it * 747796405) & 0x7FFFFFFF) % n_rows and row2 the
    same with 1103515245."""
    it = np.arange(n_iters, dtype=np.int64)
    return (((it * 747796405) & 0x7FFFFFFF) % n_rows,
            ((it * 1103515245) & 0x7FFFFFFF) % n_rows)


# Which of an iteration's two rows a mode visits as a leaf, in order.
_LEAF_ROWS = {"leaf": (0,), "leaf_sld": (0,), "super_leaf": (1,), "leaf2": (0, 1),
              "leaf24": (0, 1)}


def _leaf_chunks(row, row2, mode):
    """The (row, four-slot chunk) pairs an iteration's leaf visits test,
    in the kernel's order."""
    rows = [(row, row2)[k] for k in _LEAF_ROWS.get(mode, ())]
    if mode == "leaf2":  # the pair body takes chunk q of both rows in turn
        return [(r, q) for q in range(3) for r in rows]
    return [(r, q) for r in rows for q in range(3)]


def visit_work(tab, n_visits, mode):
    """(operations per ray, distinct table rows read) of one launch, from
    the row sequence and the table's own prim ids."""
    n_iters = n_iterations(n_visits, mode)
    seq = row_sequence(n_iters, tab.table.shape[0])
    n_ids = (tab.table[:, 108:120] >= 0).sum(dim=1).cpu().numpy()
    ops = _BOXES.get(mode, 0) * _OPS_PER_BOX * n_iters
    ops += sum(int(n_ids[seq[k]].sum()) for k in _LEAF_ROWS.get(mode, ())) * _OPS_PER_PRIM
    two = mode in PAIR_MODES or mode in ("super32", "leaf24")
    distinct = np.unique(np.concatenate(seq) if two else seq[0]).shape[0]
    return ops, distinct


def _check(tab, rays, n_visits, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if int(n_visits) < 0:
        raise ValueError(f"n_visits must be >= 0, got {n_visits!r}")
    return pk._check(tab, rays, None)


def visit_microbench_plain(tab, ox, oy, oz, dx, dy, dz, tnear, tfar, n_visits, mode):
    """K5's contract in plain PyTorch: one iteration of the mode's visits
    per loop step, every ray against the same row, in the kernel's test
    order (a leaf visit's slots in sequence with strict t < best, so the
    minimum wins and the first slot among equals)."""
    rays = (ox, oy, oz, dx, dy, dz, tnear, tfar)
    n, dev, rows, _ = _check(tab, rays, n_visits, mode)
    table = tab.table
    tablef = table.view(REAL)
    i64 = torch.int64
    o = tuple(c[:, None] for c in (ox, oy, oz))
    dd = tuple(c[:, None] for c in (dx, dy, dz))
    inv = tuple(pk._inv_dir(c) for c in dd)
    oinv = tuple(a * b for a, b in zip(o, inv))
    tn = tnear[:, None]
    best = tfar.clone()
    prim = torch.full((n,), -1, dtype=INT, device=dev)
    word = torch.zeros(n, dtype=i64, device=dev)
    n_iters = n_iterations(n_visits, mode)
    seq, seq2 = row_sequence(n_iters, rows)
    valid = [int(v) & _M32 for v in table[:, 120].cpu().numpy()]

    def super_mask(box_rows, best_now):
        rf = torch.cat([tablef[r, :96].reshape(1, 16, 6) for r in box_rows], dim=1)
        enters = pk._slab_hits(rf, inv, oinv, tn, best_now[:, None])
        bit = torch.arange(rf.shape[1], dtype=i64, device=dev)
        return (enters.to(i64) << bit).sum(dim=1) & valid[box_rows[0]]

    for it in range(n_iters):
        row, row2 = int(seq[it]), int(seq2[it])
        best_in = best  # the super visits of a step test against the step's first best
        chunks = _leaf_chunks(row, row2, mode)
        if chunks:
            geo = torch.cat([tablef[r, q * 36:(q + 1) * 36].reshape(1, 4, 9) for r, q in chunks],
                            dim=1)
            pid = torch.cat([table[r, 108 + 4 * q:112 + 4 * q].reshape(1, 4) for r, q in chunks],
                            dim=1)
            tt, hit = pk._prim_hits(geo, pid, o, dd, tn, best[:, None], None)
            j = torch.where(hit, tt, float("inf")).argmin(dim=1)
            got = hit.any(dim=1)
            best = torch.where(got, tt.gather(1, j[:, None]).squeeze(1), best)
            prim = torch.where(got, pid.expand(n, -1).gather(1, j[:, None]).squeeze(1), prim)
        if mode == "empty":
            word = word | valid[row]
        elif mode in ("super", "super_sld", "super_leaf"):
            word = word | super_mask([row], best_in)
        elif mode == "super2":
            word = word | super_mask([row], best_in) | super_mask([row2], best_in)
        elif mode == "super32":
            word = word | super_mask([row, row2], best_in)
    return best, prim, ((word + 2 ** 31) % 2 ** 32 - 2 ** 31).to(INT)


def visit_microbench(tab, ox, oy, oz, dx, dy, dz, tnear, tfar, n_visits, mode):
    """K5: n_visits visits of `mode` for every ray over the rows of `tab`.
    Returns (t, prim, word); see the module docstring."""
    rays = (ox, oy, oz, dx, dy, dz, tnear, tfar)
    n, dev, rows, _ = _check(tab, rays, n_visits, mode)
    if dev.type == "cpu":
        return visit_microbench_plain(tab, *rays, n_visits, mode)
    if dev.type != "cuda":
        raise ValueError(f"the visit microbenchmark runs on cuda or cpu tensors, not {dev}")
    lib = _load()
    t = torch.empty(n, dtype=REAL, device=dev)
    prim = torch.empty(n, dtype=INT, device=dev)
    word = torch.empty(n, dtype=INT, device=dev)
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.gdpt_visit_microbench(
            ptr(tab.table), rows, MODES.index(mode), n_iterations(n_visits, mode),
            *map(ptr, rays), n, ptr(t), ptr(prim), ptr(word),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    LAUNCHES[mode] += n > 0
    if err != 0:
        raise RuntimeError(f"visit_microbench_kernel launch failed: CUDA error {err}")
    return t, prim, word


def random_rays(tab, n_rays, seed=0):
    """n_rays rays with origins uniform in the table's scene box and
    uniform directions (the reference's benchmark rays), as the eight
    contiguous (N,) arrays on the table's device."""
    dev = tab.table.device
    rng = np.random.RandomState(seed)
    bbox = tab.bbox.cpu().numpy()
    lo, hi = bbox[:3], bbox[3:]
    o = lo + rng.rand(n_rays, 3).astype(np.float32) * (hi - lo)
    d = rng.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cols = [np.ascontiguousarray(a[:, i]) for a in (o, d) for i in range(3)]
    cols += [np.full(n_rays, 1e-4, np.float32), np.full(n_rays, 3e37, np.float32)]
    return tuple(torch.from_numpy(c).to(dev) for c in cols)


def run(tab, n_rays=262_144, n_visits=2048, modes=MODES, reps=3, out=print):
    """Time every mode on `tab` (on a CUDA device) with CUDA events over
    `reps` launches after a warm-up launch. Prints one line per mode and
    returns {mode: (ms per launch, ns per visit per ray)}."""
    if tab.table.device.type != "cuda":
        raise ValueError("the visit microbenchmark is timed on a CUDA device")
    rays = random_rays(tab, n_rays)
    out(f"table rows {tab.table.shape[0]}, width {tab.width}, n_rays {n_rays}, "
        f"n_visits {n_visits}")
    results, base = {}, None
    for mode in modes:
        visit_microbench(tab, *rays, n_visits, mode)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            visit_microbench(tab, *rays, n_visits, mode)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        per = ms * 1e6 / max(n_visits * n_rays, 1)
        extra = "" if base is None else f"  ({per - base:+.5f} over empty)"
        if mode == "empty":
            base = per
        out(f"{mode:10s}: {ms:9.3f} ms/launch  {per:8.5f} ns/visit/ray{extra}")
        results[mode] = (ms, per)
    return results


def main(argv):
    from gdpt_tpu_torch.core.dtypes import resolve_device
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    n_rays = int(argv[1]) if len(argv) > 1 else 262_144
    n_visits = int(argv[2]) if len(argv) > 2 else 2048
    modes = tuple(argv[3].split(",")) if len(argv) > 3 else MODES
    device = resolve_device(None)
    scene = scene_to(presets.icosphere_box(512, 512, 1), device)
    print(torch.cuda.get_device_name(device))
    for wide in (32, 16):
        tab = path_soa.scene_soa_from_aos(scene, wide=wide).geom.packet
        run(tab, n_rays, n_visits, modes)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
