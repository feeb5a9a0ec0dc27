"""gdpt.bounce_host_ms_per_msample: the host's ms in the gradient-domain
bounces (the program span gdpt.bounce: the base's and four offsets'
shading and casts of one bounce), per million pixel samples of the
frames run outside the warm frame and the profiler; None where the
program opens no such span."""

from benchmark.harness import spans

SPAN = "gdpt.bounce"


def read(rec):
    prof = spans.registry()
    if prof is None or prof.untraced([SPAN])[1] == 0:
        return None
    msamples = spans.untraced_msamples(rec, prof)
    if not msamples:
        return None
    return spans.untraced_ms(prof, [SPAN]) / msamples
