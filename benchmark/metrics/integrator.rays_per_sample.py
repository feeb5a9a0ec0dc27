"""integrator.rays_per_sample: rays the program counted
(render(..., return_stats=True): camera, bounce, shadow, probe and replay
rays) over the profiled frames, per pixel sample."""


def read(rec):
    p = rec.profile
    if p is None or p.samples == 0:
        return None
    return p.rays / p.samples
