"""Fit per-dispatch overhead against per-cast kernel cost.

Counterpart of tools/chain_sweep.py: K = 1, 2, 4, 8 and 16 chained K3 (or
K4, --dual) casts of the captured pool's morton-sorted rays, after one
cast's hit fraction is printed (a kernel that exits at once cannot look
fast). On the card each K is timed twice: eager (K host launches between
synchronizes) and captured as one CUDA graph (no host launch between the
casts); time(K) = C + K x cast is fitted to each by least squares. The
eager C less the graph C is the host's cost of a dispatch. On the CPU only
the eager chain is timed.

    python -m gdpt_tpu_torch.tools.chain_sweep [scene] [--dual] [--pool N]
        [--width W --height H] [--device cpu]

scene: a scene file or a preset of tools/stand_ins.py (default
icosphere_box, the stand-in for the reference's sponza). --dual walks the
16-wide table with K4 (the reference's dual on its default table would
quietly take the solo kernel where that table is 32-wide); K3 walks the
default 32-wide table.
"""

import argparse
import json
import sys

import numpy as np

from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.tools import stand_ins
from gdpt_tpu_torch.tools.ab_dual_kernel import (_sorted_packets, chain_ms, nudged, pool_rays,
                                                 walk)

DEFAULT_SCENE = "icosphere_box"
KS = (1, 2, 4, 8, 16)


def fit(ks, ms):
    """(C ms, ms a cast) of time(K) = C + K x cast, least squares."""
    cast, c = np.polyfit(np.asarray(ks, float), np.asarray(ms, float), 1)
    return float(c), float(cast)


def sweep(scene, dual=False, pool=1 << 18, ks=KS, reps=4):
    """Rows (dicts): a "hits" row (hit_frac, rays, dual), one row per K
    (eager_ms, graph_ms: None on the CPU, and Mrays/s of each), and one
    "fit" row per timing (C_ms, cast_ms)."""
    device = scene.device.camera.sample_to_cam.device
    sc = ps.scene_soa_from_aos(scene, wide=16 if dual else 32)
    tab = sc.geom.packet
    if tab is None:
        raise ValueError("chain_sweep needs a scene with a packet table")
    eps = float(scene.static.intersection_epsilon)
    packed, n = _sorted_packets(tab, *pool_rays(scene, pool), eps)
    trace = walk(tab, trs._table_n_tris(scene.static), dual=dual)
    _, prim = trace(*packed)
    rows = [{"hit_frac": float((prim >= 0).double().mean()), "rays": n, "dual": dual}]
    graph = device.type == "cuda"
    per_k = []
    for k in ks:
        row = {"K": k, "eager_ms": chain_ms(nudged(trace, packed), k, device, graph=False,
                                            reps=reps)}
        row["graph_ms"] = (chain_ms(nudged(trace, packed), k, device, reps=reps) if graph
                           else None)
        for mode in ("eager", "graph"):
            ms = row[f"{mode}_ms"]
            row[f"mrays_{mode}"] = None if ms is None else n * k / (ms * 1e-3) / 1e6
        per_k.append(row)
    rows += per_k
    for mode in ("eager", "graph") if graph else ("eager",):
        c, cast = fit(ks, [r[f"{mode}_ms"] for r in per_k])
        rows.append({"fit": mode, "C_ms": c, "cast_ms": cast})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.tools.chain_sweep",
                                 description=__doc__.splitlines()[0])
    stand_ins.add_arguments(ap, DEFAULT_SCENE)
    ap.add_argument("--dual", action="store_true")
    ap.add_argument("--pool", type=int, default=1 << 18)
    args = ap.parse_args(argv)
    refused = stand_ins.refuse_without_card(args.device, ap.prog)
    if refused is not None:
        return refused
    scene, info = stand_ins.load(args.scene, args.width, args.height, device=args.device)
    stand_ins.describe(info)
    for r in sweep(scene, dual=args.dual, pool=args.pool):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
