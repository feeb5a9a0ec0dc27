"""A/B: the dual walk K4 against the solo walk K3 on real ray populations.

Counterpart of tools/ab_dual_kernel.py: the same morton-sorted rays (the
captured wavefront pool's, and speed_of_light._harvest_rays' bounce and
shadow rays) cast through packet_kernels.trace_packets with dual=False
(K3) and dual=True (K4) on the scene's 16-wide packet table. K4's t and
prim must equal K3's, ray for ray, before any time is taken. Each timing
chains CHAIN_K casts, each cast's origins nudged by 1e-20 times the
previous cast's first t (the reference's carry-dependent perturbation;
it changes no origin's bits), captured as one CUDA graph on the card
(speed_of_light.chained_ms) and replayed; on the CPU the casts run eagerly.

    python -m gdpt_tpu_torch.tools.ab_dual_kernel [scene] [--pool N]
        [--harvest N] [--width W --height H] [--device cpu]

scene: a scene file or a preset of tools/stand_ins.py (default
icosphere_box, the stand-in for the reference's sponza).
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from gdpt_tpu_torch.accel import packet_kernels as pk
from gdpt_tpu_torch.accel import packet_trace as pt
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core.dtypes import REAL
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.tools import speed_of_light as sol
from gdpt_tpu_torch.tools import stand_ins
from gdpt_tpu_torch.tools.profile_wavefront import timed
from gdpt_tpu_torch.tools.wavefront_visits import capture_pool_rays

DEFAULT_SCENE = "icosphere_box"
CHAIN_K = 8


def sort_perm(tab, org, d, tnear, tfar=3e37):
    """(scrubbed org, d, tnear, tfar, the sort's permutation), the sort
    of trace_packet_soa: morton keys, dead lanes last, a stable argsort."""
    org, d, tnear, tfar, alive = pt._scrub(org, d, tnear, tfar)
    keys = torch.where(alive, pt._morton_keys(tab, org, d), 2**30)
    return org, d, tnear, tfar, torch.argsort(keys, stable=True)


def _sorted_packets(tab, org, d, tnear, tfar=3e37):
    """Morton-sort rays exactly as trace_packet_soa does: the eight
    contiguous ray arrays K3 and K4 take (ox, oy, oz, dx, dy, dz, tnear,
    tfar), and the ray count. The reference packs them into (M, 128)
    packets; the port's walks take flat arrays."""
    org, d, tnear, tfar, perm = sort_perm(tab, org, d, tnear, tfar)
    return [c[perm].contiguous() for c in (*org, *d, tnear, tfar)], org.x.shape[0]


def pool_rays(scene, pool=1 << 18):
    """The captured wavefront pool's rays on the scene's device (V3, V3)."""
    rays = capture_pool_rays(scene, warm_chunks=3, pool=pool)
    device = scene.device.camera.sample_to_cam.device
    return sol._rays(np.stack([rays[k] for k in ("ox", "oy", "oz")], 1),
                     np.stack([rays[k] for k in ("dx", "dy", "dz")], 1), device)


def nudged(trace, packed):
    """A cast of the packed rays whose origins move by 1e-20 times the
    previous cast's first t, clamped to [-1, 1] (a missing lane's t is
    3e37, an any-hit one's may be negative): the reference's chain."""
    ox, *rest = packed
    carry = [torch.zeros((), dtype=REAL, device=ox.device)]

    def cast():
        eps = 1e-20 * torch.clamp(carry[0], -1.0, 1.0)
        t, prim = trace(ox + eps, *rest)
        carry[0] = carry[0] + t[0]
        return t, prim
    return cast


def chain_ms(cast, k, device, graph=True, reps=3):
    """Least ms of k chained casts: on the card captured as one CUDA
    graph and replayed (graph=True), or launched eagerly between
    synchronizes; on the CPU eagerly."""
    dev = torch.device(device)
    if dev.type == "cuda" and graph:
        return sol.chained_ms(cast, reps, k=k)[0]
    cuda = dev.type == "cuda"
    for _ in range(2):
        cast()
    best = float("inf")
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(k):
            cast()
        if cuda:
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def walk(tab, n_tris, any_hit=False, dual=False):
    """trace_packets on `tab` as a function of the eight ray arrays."""
    return lambda *rays: pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit,
                                          dual=dual)


def timed_row(label, trace, packed, n, device, k=CHAIN_K, **extra):
    """One A/B row: Mrays/s and ms a cast of k chained casts, and one
    eager cast's row (profile_wavefront.timed: its wall and, on the card,
    its launches and device time)."""
    ms = chain_ms(nudged(trace, packed), k, device)
    _, one = timed(trace, *packed, device=device)
    return {"label": label, "rays": n, "chain": k, "ms_per_cast": ms / k,
            "mrays": n * k / (ms * 1e-3) / 1e6, **extra, **one}


def ray_sets(scene, sc, tab, pool=1 << 18, harvest=1 << 19):
    """{name: (packed, n, any_hit)}: the pool rays (closest hit), the
    harvested bounce rays (closest) and shadow rays (any hit), each sorted
    by _sorted_packets with the scene's intersection epsilon as tnear."""
    eps = float(scene.static.intersection_epsilon)
    bounce, shadow = sol._harvest_rays(scene, sc, m=harvest, out=lambda s: None)
    out = {}
    for name, rays, any_hit in (("pool", pool_rays(scene, pool), False),
                                ("bounce", bounce, False), ("shadow", shadow, True)):
        packed, n = _sorted_packets(tab, *rays, eps)
        out[name] = (packed, n, any_hit)
    return out


def _check_same(a, b, label):
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        bad = int(((a[0] != b[0]) | (a[1] != b[1])).sum())
        raise AssertionError(f"K4 differs from K3 on {bad} {label} rays")


def ab(scene, pool=1 << 18, harvest=1 << 19, k=CHAIN_K):
    """Rows (dicts) of K3 ("solo") and K4 ("dual") on the 16-wide table,
    per ray set; K4's hits are held equal to K3's first."""
    device = scene.device.camera.sample_to_cam.device
    sc = ps.scene_soa_from_aos(scene, wide=16)
    tab = sc.geom.packet
    if tab is None:
        raise ValueError("ab_dual_kernel needs a scene with a packet table")
    n_tris = trs._table_n_tris(scene.static)
    rows = [{"label": "table", "rows16": int(tab.table.shape[0])}]
    for name, (packed, n, any_hit) in ray_sets(scene, sc, tab, pool, harvest).items():
        solo, dual = walk(tab, n_tris, any_hit), walk(tab, n_tris, any_hit, dual=True)
        _check_same(solo(*packed), dual(*packed), name)
        hits = float((solo(*packed)[1] >= 0).double().mean())
        rows.append(timed_row(f"{name}_solo", solo, packed, n, device, k, hit_frac=hits))
        rows.append(timed_row(f"{name}_dual", dual, packed, n, device, k, hit_frac=hits))
    return rows


def summary(config, rows):
    """The reference's JSON line: Mrays/s per ray set and kernel."""
    out = {"config": config, "unit": "Mrays/s"}
    for r in rows:
        if "mrays" in r:
            out[r["label"]] = round(r["mrays"], 3)
        else:
            out.update({k: v for k, v in r.items() if k != "label"})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.tools.ab_dual_kernel",
                                 description=__doc__.splitlines()[0])
    stand_ins.add_arguments(ap, DEFAULT_SCENE)
    ap.add_argument("--pool", type=int, default=1 << 18)
    ap.add_argument("--harvest", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    refused = stand_ins.refuse_without_card(args.device, ap.prog)
    if refused is not None:
        return refused
    scene, info = stand_ins.load(args.scene, args.width, args.height, device=args.device)
    stand_ins.describe(info)
    rows = ab(scene, pool=args.pool, harvest=args.harvest)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps(summary(args.scene, rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
