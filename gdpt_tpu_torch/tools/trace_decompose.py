"""Decompose the packet cast (trace_packet_soa) on captured pool rays.

Counterpart of tools/trace_decompose.py: the cast's wall split into its
sort (morton keys, stable argsort, the takes), the whole cast with
sort_rays=True, the cast of pre-sorted rays (sort_rays=False), the walk
K3 alone on contiguous pre-sorted rays (closest and any hit), and the two
steps the reference's split leaves inside the cast: the unsort (one
index_copy_ of t and of prim) and the hit attributes (_hit_attribs). Each
is timed as the reference's stages (tools/profile_wavefront.timed: wall,
and on the card the stage's kernel launches, its device time where the
profiler recorded it whole, and its span between CUDA events, which is
the device time of the one-launch walk and of the unsort). The
pre-sorted cast, unsorted, must give the sorted cast's t and prim bit for
bit.

    python -m gdpt_tpu_torch.tools.trace_decompose [scene] [rays.npz]
        [--pool N] [--width W --height H] [--device cpu]

scene: a scene file or a preset of tools/stand_ins.py (default
icosphere_box, the stand-in for the reference's sponza). rays.npz: ox, oy,
oz, dx, dy, dz and bounce arrays (tools/wavefront_visits' capture);
without it the pool's rays are captured here.
"""

import argparse
import sys

import numpy as np
import torch

from gdpt_tpu_torch.accel import packet_kernels as pk
from gdpt_tpu_torch.accel import packet_trace as pt
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core.dtypes import BIG, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.tools import speed_of_light as sol
from gdpt_tpu_torch.tools import stand_ins
from gdpt_tpu_torch.tools.ab_dual_kernel import sort_perm
from gdpt_tpu_torch.tools.profile_wavefront import timed
from gdpt_tpu_torch.utils.profiling import device_note
from gdpt_tpu_torch.tools.wavefront_visits import capture_pool_rays

DEFAULT_SCENE = "icosphere_box"


def decompose(scene, rays=None, pool=1 << 18, reps=3):
    """Rows (dicts): a "rays" row (rays, table rows), one row per stage
    (stage_profile's wall_ms, event_ms, launches, device_ops, device_ms,
    hand_ms, hand_launches and whole; Mrays/s), and a "check" row: the pre-sorted cast unsorted against the
    sorted cast
    (rays differing in the bits of t or in prim; raises unless 0).
    rays: capture_pool_rays' dict (or an .npz of it); None captures."""
    static = scene.static
    device = scene.device.camera.sample_to_cam.device
    tab = ps.scene_soa_from_aos(scene).geom.packet
    if tab is None:
        raise ValueError("trace_decompose needs a scene with a packet table")
    n_tris = trs._table_n_tris(static)
    if rays is None:
        rays = capture_pool_rays(scene, warm_chunks=3, pool=pool)
    org, d = sol._rays(np.stack([rays[k] for k in ("ox", "oy", "oz")], 1),
                       np.stack([rays[k] for k in ("dx", "dy", "dz")], 1), device)
    n = org.x.shape[0]
    bounce = torch.from_numpy(np.asarray(rays["bounce"])).to(device)
    tnear = torch.where(bounce == 0, 0.0, static.intersection_epsilon)
    tfar = torch.full((n,), BIG, dtype=REAL, device=device)
    rows = [{"stage": "rays", "rays": n, "table_rows": int(tab.table.shape[0]),
             "width": tab.width}]

    def stage(name, fn, *args):
        out, row = timed(fn, *args, device=device, reps=reps)
        rows.append({"stage": name, **row, "mrays": n / (row["wall_ms"] * 1e-3) / 1e6})
        return out

    def sort_only(o, dd, tn, tf):
        o, dd, tn, tf, perm = sort_perm(tab, o, dd, tn, tf)
        return V3(*(c[perm] for c in o)), V3(*(c[perm] for c in dd)), tn[perm], tf[perm], perm

    sorg, sd, stn, stf, perm = stage("sort", sort_only, org, d, tnear, tfar)

    def cast(sort_rays):
        return lambda o, dd, tn, tf: pt.trace_packet_soa(tab, o, dd, tn, tf, n_tris=n_tris,
                                                         sort_rays=sort_rays)

    full = stage("trace_sorted", cast(True), org, d, tnear, tfar)
    pre = stage("trace_presorted", cast(False), sorg, sd, stn, stf)
    packed = [c.contiguous() for c in (*sorg, *sd, stn, stf)]
    t, prim = stage("kernel", lambda *a: pk.trace_packets(tab, *a, n_tris=n_tris), *packed)
    stage("kernel_any_hit", lambda *a: pk.trace_packets(tab, *a, n_tris=n_tris, any_hit=True),
          *packed)
    t_u, p_u = stage("unsort", lambda a, b: (torch.empty_like(a).index_copy_(0, perm, a),
                                             torch.empty_like(b).index_copy_(0, perm, b)),
                     t, prim)
    stage("hit_attribs", lambda a, b: pt._hit_attribs(tab, org, d, a, b, n_tris), t_u, p_u)

    pre_t = torch.empty_like(pre[0]).index_copy_(0, perm, pre[0])
    pre_p = torch.empty_like(pre[1]).index_copy_(0, perm, pre[1])
    bad = int(((pre_t.view(torch.int32) != full[0].view(torch.int32))
               | (pre_p != full[1])).sum())
    rows.append({"stage": "check", "rays_differing": bad,
                 "hit_frac": float((full[1] >= 0).double().mean())})
    if bad:
        raise AssertionError(f"the pre-sorted cast, unsorted, differs from the sorted cast on "
                             f"{bad} of {n} rays")
    return rows


LABELS = {"sort": "morton keys + argsort + take x8", "trace_sorted": "trace sort_rays=True",
          "trace_presorted": "trace presorted (cast, no sort)", "kernel": "trace_packets alone",
          "kernel_any_hit": "trace_packets any_hit", "unsort": "unsort (index_copy_ x2)",
          "hit_attribs": "_hit_attribs"}


def print_rows(rows, out=print):
    for r in rows:
        if r["stage"] == "rays":
            out(f"{r['rays']} rays, table rows {r['table_rows']} ({r['width']}-wide)")
        elif r["stage"] == "check":
            out(f"pre-sorted cast, unsorted, against the sorted cast: {r['rays_differing']} "
                f"rays differ; hit fraction {r['hit_frac']:.4f}")
        else:
            note = device_note(r, hand="K3")
            dev = f" [{note}]" if note else ""
            out(f"{LABELS[r['stage']] + ':':<33}{r['wall_ms']:7.1f} ms "
                f"({r['mrays']:5.2f} Mrays/s){dev}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.tools.trace_decompose",
                                 description=__doc__.splitlines()[0])
    stand_ins.add_arguments(ap, DEFAULT_SCENE)
    ap.add_argument("rays", nargs="?", default=None, help="an .npz of captured rays")
    ap.add_argument("--pool", type=int, default=1 << 18)
    args = ap.parse_args(argv)
    refused = stand_ins.refuse_without_card(args.device, ap.prog)
    if refused is not None:
        return refused
    scene, info = stand_ins.load(args.scene, args.width, args.height, device=args.device)
    stand_ins.describe(info)
    rays = None if args.rays is None else dict(np.load(args.rays))
    print_rows(decompose(scene, rays=rays, pool=args.pool))
    return 0


if __name__ == "__main__":
    sys.exit(main())
