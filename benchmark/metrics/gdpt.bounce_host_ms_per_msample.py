"""gdpt.bounce_host_ms_per_msample: the host's ms in the gradient-domain
bounces (the program span gdpt.bounce: the base's and four offsets'
shading and casts of one bounce), per million pixel samples of the
frames run outside the warm frame and the profiler; None where the
program opens no such span.

Not a metric of BENCHMARK.json: a replayed gradpath sample opens no
gdpt.bounce span, so in the cell it read nothing, and the host's time in
a replayed pass is render.pass's. The reader stays only as long as
tests/test_torch_tracing.py's gdpt.* reader tests load it by name.
"""

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
