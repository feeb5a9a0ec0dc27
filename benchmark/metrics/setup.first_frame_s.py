"""setup.first_frame_s: seconds of the process's first render.frame (the
program span's warm bucket): the run's warm-up frame, which holds the
CUDA context's first use, the native libraries' loads, the scene's
upload and view and each kernel's first launch."""

from benchmark.harness import spans


def read(rec):
    prof = spans.registry()
    if prof is None:
        return None
    stats = prof.span_stats(spans.FRAME)
    if stats["warm_calls"] == 0:
        return None
    return stats["warm_ns"] / 1e9
