"""device.busy_ms_per_msample: the summed time of every device operation
in the profiled frames, in ms per million pixel samples."""


def read(rec):
    p = rec.profile
    if p is None or not p.whole or p.device_s <= 0:
        return None
    return p.device_s * 1e3 / (p.samples / 1e6)
