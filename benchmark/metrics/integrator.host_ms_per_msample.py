"""integrator.host_ms_per_msample: the host's ms in the passes (the
program span render.pass) less the casts in them (cast.closest,
cast.shadow), per million pixel samples of the frames run outside the
warm frame and the profiler."""

from benchmark.harness import spans


def read(rec):
    prof = spans.registry()
    if prof is None or prof.untraced([spans.PASS])[1] == 0:
        return None
    msamples = spans.untraced_msamples(rec, prof)
    if not msamples:
        return None
    ms = spans.untraced_ms(prof, [spans.PASS]) - spans.untraced_ms(prof, spans.CASTS)
    return ms / msamples
