"""integrator.fused_share: the share of the banded path passes' pixel
samples that the program traced by its fused stages (its counter group
path_soa.fused: fused / (fused + plain)) over the run, replays included;
None where the program keeps no such counters or traced no path sample."""


def read(rec):
    try:
        from gdpt_tpu_torch.utils import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "counters", dict)().get("path_soa.fused")
    if not counts:
        return None
    samples = counts.get("fused", 0) + counts.get("plain", 0)
    return counts.get("fused", 0) / samples if samples else None
