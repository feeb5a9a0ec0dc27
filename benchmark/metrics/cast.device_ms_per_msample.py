"""cast.device_ms_per_msample: device time of the ray-casting kernels
K1-K4 (matched by name) over the profiled frames, in ms per million pixel
samples."""


def read(rec):
    p = rec.profile
    if p is None or not p.whole or p.hand_s <= 0:
        return None
    return p.hand_s * 1e3 / (p.samples / 1e6)
