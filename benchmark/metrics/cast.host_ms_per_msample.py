"""cast.host_ms_per_msample: the host's ms in the casts (the program
spans cast.closest and cast.shadow: the dispatch, checks and launches of
K1-K4), per million pixel samples of the frames run outside the warm
frame and the profiler; cast.device_ms_per_msample is the same casts'
device time."""

from benchmark.harness import spans


def read(rec):
    prof = spans.registry()
    if prof is None or prof.untraced(spans.CASTS)[1] == 0:
        return None
    msamples = spans.untraced_msamples(rec, prof)
    if not msamples:
        return None
    return spans.untraced_ms(prof, spans.CASTS) / msamples
