"""device.idle_share: 1 - (the union of the device's operation
intervals) / (the profiled frames' wall)."""


def read(rec):
    p = rec.profile
    if p is None or not p.whole or p.wall_s <= 0:
        return None
    return 1.0 - p.busy_s / p.wall_s
