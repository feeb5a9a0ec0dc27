"""setup_s: seconds from process start to the first timed frame (torch
import, CUDA context, native libraries, the scene's parse, the warm-up
frame)."""


def read(rec):
    return rec.setup_s
