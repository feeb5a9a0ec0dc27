"""The program's span registry (gdpt_tpu_torch.utils.profiling) as the
span metrics under benchmark/metrics read it.

The program times its own host work in named spans (render.frame, the
frame's fixed parts, the pass, the casts) and keeps apart the calls of
its first render.frame (the run's warm-up frame) and those made under the
profiler. The metrics read the other calls, the frames the window's
untraced timing sees. Each returns None where the program keeps no such
registry or ran no render.frame.
"""

FRAME = "render.frame"
# The frame's host work outside the pass: the scene's memoised copy and
# view, the lane columns and their copies, the read-back, the image.
FIXED = ("render.scene", "render.lanes", "render.readback", "render.image")
PASS = "render.pass"
CASTS = ("cast.closest", "cast.shadow")


def registry():
    """The program's profiling module where it keeps spans and has run a
    render.frame, else None."""
    try:
        from gdpt_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "untraced") and hasattr(profiling, "span_stats")):
        return None
    if profiling.span_stats(FRAME)["calls"] == 0:
        return None
    return profiling


def untraced_ms(prof, names):
    """Summed ms of the spans `names` over their untraced calls."""
    return prof.untraced(names)[0] / 1e6


def untraced_frames(prof):
    """render.frame calls outside the warm frame and the profiler."""
    return prof.untraced([FRAME])[1]


def untraced_msamples(rec, prof):
    """Million pixel samples of the untraced frames, each frame at the
    window's mean samples per pixel; None without one."""
    frames = untraced_frames(prof)
    if frames == 0 or not rec.frames:
        return None
    spp = sum(f.spp for f in rec.frames) / len(rec.frames)
    return frames * spp * rec.width * rec.height / 1e6
