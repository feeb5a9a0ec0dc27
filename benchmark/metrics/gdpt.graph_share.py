"""gdpt.graph_share: the share of the gradient-domain samples that the
program replayed from a captured CUDA graph (its counter group
gdpt_soa.graphs: replayed / (replayed + eager)) over the run; None where
the program keeps no such counters or ran no gradient-domain sample."""


def read(rec):
    try:
        from gdpt_tpu_torch.utils import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "counters", dict)().get("gdpt_soa.graphs")
    if not counts:
        return None
    samples = counts.get("replayed", 0) + counts.get("eager", 0)
    return counts.get("replayed", 0) / samples if samples else None
