"""gdpt.solve_ms_per_frame: the host's ms a frame in the reconstruction
(the program span gdpt.solve: the gradients' assembly, the
screened-Poisson solve and the image's copy to the host), over the
frames run outside the warm frame and the profiler; None where the
program opens no such span."""

from benchmark.harness import spans

SPAN = "gdpt.solve"


def read(rec):
    prof = spans.registry()
    if prof is None or prof.untraced([SPAN])[1] == 0 or spans.untraced_frames(prof) == 0:
        return None
    return spans.untraced_ms(prof, [SPAN]) / spans.untraced_frames(prof)
