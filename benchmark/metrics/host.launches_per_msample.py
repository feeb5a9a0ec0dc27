"""host.launches_per_msample: operations the host put on the device
(kernel launches, copies, fills, counted from its CUDA runtime calls)
over the profiled frames, per million pixel samples."""


def read(rec):
    p = rec.profile
    if p is None or not p.whole:
        return None
    return p.launches / (p.samples / 1e6)
