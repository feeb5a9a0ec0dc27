"""render.fixed_ms_per_frame: the host's ms a frame in the frame's fixed
work around its pass (the program spans render.scene, render.lanes,
render.readback and render.image), over the frames run outside the warm
frame and the profiler."""

from benchmark.harness import spans


def read(rec):
    prof = spans.registry()
    if prof is None or spans.untraced_frames(prof) == 0:
        return None
    return spans.untraced_ms(prof, spans.FIXED) / spans.untraced_frames(prof)
