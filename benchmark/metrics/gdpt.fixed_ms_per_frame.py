"""gdpt.fixed_ms_per_frame: the host's ms a gradient-domain frame in the
frame's fixed work around its passes and solve (the program spans of
spans.FIXED: render.scene, render.lanes, render.readback, render.image),
over the frames run outside the warm frame and the profiler; None where
the program opens no gdpt.solve span (a gradient-domain render loop
without its spans, whose fixed work is not all in spans)."""

from benchmark.harness import spans


def read(rec):
    prof = spans.registry()
    if (prof is None or prof.untraced(["gdpt.solve"])[1] == 0
            or spans.untraced_frames(prof) == 0):
        return None
    return spans.untraced_ms(prof, spans.FIXED) / spans.untraced_frames(prof)
