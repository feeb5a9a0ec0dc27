"""Per-stage breakdown of one wavefront iteration (path_soa._wavefront_body).

Counterpart of tools/profile_wavefront.py: the wavefront body replayed
stage by stage on a steady-state lane pool: regen, the extension cast
(morton-sorted and not), shade_hit, the material parameter gather, NEE
(its shadow cast included), BSDF sample/eval/pdf, the envmap's emission
and the pixel scatter-add, and the whole body, each timed as the
reference's `timed` times a jitted stage (timed,
utils/profiling.stage_profile). The reference's
stages are one jit each, so their walls are device time; the port's are
eager, so every row also carries the stage's kernel launches and device
time from one torch.profiler run (utils/profiling.stage_profile).

    python -m gdpt_tpu_torch.tools.profile_wavefront [scene] [--pool N]
        [--warm K] [--spp N] [--width W --height H] [--device cpu]

scene: a scene file or a preset of tools/stand_ins.py (default
material_box_bvh, the stand-in for the reference's disney_bsdf).
"""

import argparse
import sys

import torch

from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.ops import textures_soa as tsoa
from gdpt_tpu_torch.tools import stand_ins
from gdpt_tpu_torch.tools.wavefront_visits import regen
# The reference's `timed`: a warm call, the least wall of `reps` calls
# between synchronizes, and on the card one profiled call.
from gdpt_tpu_torch.utils.profiling import device_note
from gdpt_tpu_torch.utils.profiling import stage_profile as timed

DEFAULT_SCENE = "material_box_bvh"


def _clone(st):
    """A copy of a wavefront state: the body updates its state in place."""
    out = {}
    for k, v in st.items():
        if isinstance(v, V3):
            out[k] = V3(*(c.clone() for c in v))
        elif isinstance(v, torch.Tensor):
            out[k] = v.clone()
        else:
            out[k] = v
    return out


def profile(scene, pool=1 << 18, warm=3, spp=64, reps=3):
    """Rows (dicts) of one steady-state wavefront iteration on the
    scene's device: a "steady_state" row (iterations run, pool, alive,
    next_item, total), a "body" row, one row per stage (each with wall_ms,
    launches, device_ops, device_ms, hand_ms, hand_launches; the casts also
    with the live rays they traced and NEE with its shadow rays), and a
    "sum" row:
    the stages' walls and device times summed as the reference sums them
    (the sorted cast, the scatter-add three times)."""
    static = scene.static
    camera = scene.device.camera
    device = camera.sample_to_cam.device
    n_pix = static.width * static.height
    sc = ps.scene_soa_from_aos(scene)
    used = static.used_material_kinds
    lane_q = ps.LANE_QUANTUM
    pool = -(-pool // lane_q) * lane_q
    total = n_pix * spp

    st = ps._wavefront_state(n_pix, pool, total, 0, device)
    for _ in range(warm * 8):
        st = ps._wavefront_body(static, camera, sc, st)
    n_alive = int((st["alive"] > 0).sum())
    rows = [{"stage": "steady_state", "iters": warm * 8, "pool": pool, "alive": n_alive,
             "next_item": int(st["next_item"]), "total": total}]

    def stage(name, fn, *args, setup=None, **extra):
        out, row = timed(fn, *args, device=device, reps=reps, setup=setup)
        rows.append({"stage": name, **row, **extra})
        return out

    stage("body", lambda s: ps._wavefront_body(static, camera, sc, s),
          setup=lambda: (_clone(st),))
    org, d, bounce, alive, pixel, sample = stage(
        "regen", lambda s: regen(static, camera, s), st)
    tnear = torch.where(bounce == 0, 0.0, static.intersection_epsilon)
    tfar = torch.where(alive, BIG, -1.0)
    n_rays = int((tfar > 0).sum())

    def trace(sort_rays):
        return lambda o, dd, tn, tf: trs.intersect_soa_gn(static, sc.geom, o, dd, tn, tf,
                                                           sort_rays=sort_rays)

    hit, gn_raw = stage("trace_sorted", trace(True), org, d, tnear, tfar, rays=n_rays)
    stage("trace_unsorted", trace(False), org, d, tnear, tfar, rays=n_rays)
    v = stage("shade_hit", lambda o, dd, hh, g, r, s: ps.shade_hit(
        static, sc, o, dd, hh, g, ray_radius=r, ray_spread=s),
        org, d, hit, gn_raw, st["radius"], st["spread"])
    params = stage("gather_params", lambda vv: msoa.gather_params_soa(
        sc.mat_tables, used, vv.material_id, vv.uv_u, vv.uv_v, static.spec_image_slots,
        float_tex_slots=static.float_tex_slots, fp=vv.fp), v)

    seed = st["seed"]
    b = bounce + 1

    def ctr(c):
        return b.to(torch.int64) * ps._CTR_STRIDE + c

    v_ok = (v.valid > 0) & alive
    ext = v_ok & (st["cont"] > 0)
    dir_view = -1.0 * d
    if static.n_lights > 0:
        def nee(vv, p, e, px, sm):
            lu0, lu1 = soa.uniform2(seed, px, ctr(ps._CTR_LIGHT_UV), sm)
            lw, lsw = soa.uniform2(seed, px, ctr(ps._CTR_LIGHT_W), sm)
            return ps.nee_soa(static, sc, vv, p, dir_view, used, lu0, lu1, lw, lsw, e)

        out, row = timed(nee, v, params, ext, pixel, sample, device=device, reps=reps)
        rows.append({"stage": "nee", **row, "shadow_rays": int(out[1].sum())})

    def bsdf(vv, p, px, sm):
        bu0, bu1 = soa.uniform2(seed, px, ctr(ps._CTR_BSDF_UV), sm)
        w_lobe, _ = soa.uniform2(seed, px, ctr(ps._CTR_BSDF_W), sm)
        samp = msoa.sample_bsdf_soa(p, dir_view, vv.gn, vv.frame, bu0, bu1, w_lobe, used)
        f_b = msoa.eval_bsdf_soa(p, dir_view, samp.dir_out, vv.gn, vv.frame, used)
        pdf_b = msoa.pdf_bsdf_soa(p, dir_view, samp.dir_out, vv.gn, vv.frame, used)
        return samp, f_b, pdf_b

    stage("bsdf", bsdf, v, params, pixel, sample)
    if static.has_envmap:
        stage("envmap", lambda dd, s: tsoa.envmap_emission_soa(
            ps._env_view(static, sc), sc.mat_tables.pool3, dd, spread=s), d, st["spread"])
    stage("scatter", lambda acc, px, c: acc.index_add_(0, px, c),
          setup=lambda: (st["acc_x"].clone(), pixel, st["rr_prev"]))

    by = {r["stage"]: r for r in rows}
    parts = ["regen", "trace_sorted", "shade_hit", "gather_params", "bsdf", "scatter",
             "scatter", "scatter"] + [k for k in ("nee", "envmap") if k in by]
    summed = {"stage": "sum", "parts": parts,
              "wall_ms": sum(by[k]["wall_ms"] for k in parts)}
    for key in ("event_ms", "launches", "device_ops", "device_ms", "hand_ms", "hand_launches"):
        vals = [by[k][key] for k in parts]
        summed[key] = None if None in vals else sum(vals)
    rows.append(summed)
    return rows


def _fmt(row):
    note = device_note(row)
    return f"{row['wall_ms']:8.1f} ms" + (f"  [{note}]" if note else "")


def print_rows(rows, out=print):
    """The reference's lines, each with its device split where measured."""
    by = {r["stage"]: r for r in rows}
    s = by["steady_state"]
    out(f"steady state after {s['iters']} iters: alive={s['alive']}/{s['pool']} "
        f"({s['alive'] / s['pool']:.2f}), next_item={s['next_item']}/{s['total']}")
    body = by["body"]
    out(f"full _wavefront_body:        {_fmt(body)} "
        f"({body['wall_ms'] / s['pool'] * 1e6:6.0f} ns/lane)")
    labels = [("regen", "regen"), ("trace_sorted", "extension trace (sorted)"),
              ("trace_unsorted", "extension trace (no sort)"), ("shade_hit", "shade_hit"),
              ("gather_params", "gather_params"), ("nee", "NEE (incl shadow trace)"),
              ("bsdf", "bsdf sample+eval+pdf"), ("envmap", "envmap_emission"),
              ("scatter", "pixel scatter-add (x1 ch)")]
    for key, label in labels:
        if key not in by:
            continue
        r = by[key]
        tail = ""
        if "rays" in r:
            tail = f" ({r['rays'] / (r['wall_ms'] * 1e-3) / 1e6:5.2f} Mrays/s over live)"
        if "shadow_rays" in r:
            tail = f" ({r['shadow_rays']} shadow rays)"
        out(f"  {label + ':':<27}{_fmt(r)}{tail}")
    sm = by["sum"]
    dev = "" if sm["device_ms"] is None else f"; device {sm['device_ms']:.3f} ms of stages"
    out(f"  [sum of stages]            {sm['wall_ms']:8.1f} ms "
        f"(body = {body['wall_ms']:.1f} ms; gap = fusion/overlap{dev})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.tools.profile_wavefront",
                                 description=__doc__.splitlines()[0])
    stand_ins.add_arguments(ap, DEFAULT_SCENE)
    ap.add_argument("--pool", type=int, default=1 << 18)
    ap.add_argument("--warm", type=int, default=3,
                    help="wavefront chunks (x8 iters) before profiling")
    ap.add_argument("--spp", type=int, default=64)
    args = ap.parse_args(argv)
    refused = stand_ins.refuse_without_card(args.device, ap.prog)
    if refused is not None:
        return refused
    scene, info = stand_ins.load(args.scene, args.width, args.height, device=args.device)
    stand_ins.describe(info)
    sc = ps.scene_soa_from_aos(scene)
    print(f"packet={'yes' if sc.geom.packet is not None else 'no'}", flush=True)
    print_rows(profile(scene, pool=args.pool, warm=args.warm, spp=args.spp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
