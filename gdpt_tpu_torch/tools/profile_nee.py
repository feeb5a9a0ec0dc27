"""Sub-decompose the NEE stage of the path wavefront body.

Counterpart of tools/profile_nee.py: on the steady-state pool rays of
tools/wavefront_visits.capture_pool_rays, cast, shaded and with their
material parameters gathered once, it times light-point sampling, BSDF
eval and pdf toward the light, the envmap's NEE radiance tap, the shadow
cast (occluded_soa) and the whole nee_soa, each as the reference's
stages (tools/profile_wavefront.timed: wall, and on the card the stage's
kernel launches and device time).

    python -m gdpt_tpu_torch.tools.profile_nee [scene] [--pool N]
        [--width W --height H] [--device cpu]

scene: a scene file or a preset of tools/stand_ins.py (default
material_box_bvh, the stand-in for the reference's disney_bsdf).
"""

import argparse
import sys

import numpy as np
import torch

from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.integrators import vertex_soa as vx
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.ops import textures_soa as tsoa
from gdpt_tpu_torch.tools import stand_ins
from gdpt_tpu_torch.tools.profile_wavefront import timed
from gdpt_tpu_torch.utils.profiling import device_note
from gdpt_tpu_torch.tools.speed_of_light import _rays
from gdpt_tpu_torch.tools.wavefront_visits import capture_pool_rays

DEFAULT_SCENE = "material_box_bvh"


def pool_vertices(scene, pool=1 << 18, rays=None):
    """The captured pool rays (or `rays`, capture_pool_rays' dict) cast
    with tnear 0, shaded, and their material parameters: (org, d, vertex,
    params), as the reference's profile_nee and occl_ab prepare them."""
    static = scene.static
    device = scene.device.camera.sample_to_cam.device
    sc = ps.scene_soa_from_aos(scene)
    rays = capture_pool_rays(scene, warm_chunks=3, pool=pool) if rays is None else rays
    org, d = _rays(np.stack([rays[k] for k in ("ox", "oy", "oz")], 1),
                   np.stack([rays[k] for k in ("dx", "dy", "dz")], 1), device)
    hit, gn_raw = trs.intersect_soa_gn(static, sc.geom, org, d, 0.0, BIG)
    v = ps.shade_hit(static, sc, org, d, hit, gn_raw)
    params = msoa.gather_params_soa(
        sc.mat_tables, static.used_material_kinds, v.material_id, v.uv_u, v.uv_v,
        static.spec_image_slots, float_tex_slots=static.float_tex_slots, fp=v.fp)
    return org, d, v, params


def light_samples(scene, v):
    """The reference's light samples of these tools (seed 0, counters 3
    and 4): (lu0, lu1, lw, lsw)."""
    n = v.position.x.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=v.position.x.device)
    lu0, lu1 = soa.uniform2(0, idx, 3, 0)
    lw, lsw = soa.uniform2(0, idx, 4, 0)
    return lu0, lu1, lw, lsw


def profile(scene, pool=1 << 18, reps=3, rays=None):
    """Rows (dicts): a "pool" row (lanes), then one per stage (wall_ms,
    launches, device_ops, device_ms, hand_ms, hand_launches; the shadow
    cast with its live shadow rays)."""
    static = scene.static
    device = scene.device.camera.sample_to_cam.device
    sc = ps.scene_soa_from_aos(scene)
    used = static.used_material_kinds
    org, d, v, params = pool_vertices(scene, pool, rays)
    n = org.x.shape[0]
    rows = [{"stage": "pool", "pool": n}]
    lu0, lu1, lw, lsw = light_samples(scene, v)
    ext = v.valid > 0
    dir_view = -1.0 * d

    def stage(name, fn, **extra):
        out, row = timed(fn, device=device, reps=reps)
        rows.append({"stage": name, **row, **extra})
        return out

    _, p_l, n_l, _, is_env = stage("sample_light_point", lambda: vx.sample_light_point(
        static, sc, v.position, lu0, lu1, lw, lsw))
    to_l = p_l - v.position
    dist = soa.length(to_l)
    dl = soa.where(is_env, -1.0 * n_l, to_l * (1.0 / torch.clamp_min(dist, 1e-20)))
    stage("eval_bsdf", lambda: msoa.eval_bsdf_soa(params, dir_view, dl, v.gn, v.frame, used))
    stage("pdf_bsdf", lambda: msoa.pdf_bsdf_soa(params, dir_view, dl, v.gn, v.frame, used))
    if static.has_envmap:
        stage("env_tap", lambda: tsoa.envmap_emission_soa(
            ps._env_view(static, sc), sc.mat_tables.pool3, dl))
    eps_shadow = static.shadow_epsilon
    tfar = torch.where(is_env, BIG, (1.0 - eps_shadow) * dist)
    tfar = torch.where(ext, tfar, -1.0)
    stage("occluded", lambda: trs.occluded_soa(static, sc.geom, v.position, dl, eps_shadow,
                                               tfar), live_shadow=int((tfar > 0).sum()))
    stage("nee_soa", lambda: ps.nee_soa(static, sc, v, params, dir_view, used, lu0, lu1, lw,
                                        lsw, ext))
    return rows


def print_rows(rows, out=print):
    labels = {"sample_light_point": "sample_light_point", "eval_bsdf": "eval_bsdf(dl)",
              "pdf_bsdf": "pdf_bsdf(dl)", "env_tap": "env NEE radiance tap",
              "occluded": "occluded_soa", "nee_soa": "full nee_soa"}
    for r in rows:
        if r["stage"] == "pool":
            out(f"pool={r['pool']}")
            continue
        tail = f" ({r['live_shadow']} live shadow rays)" if "live_shadow" in r else ""
        note = device_note(r)
        dev = f" [{note}]" if note else ""
        out(f"  {labels[r['stage']] + ':':<27}{r['wall_ms']:8.1f} ms{tail}{dev}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.tools.profile_nee",
                                 description=__doc__.splitlines()[0])
    stand_ins.add_arguments(ap, DEFAULT_SCENE)
    ap.add_argument("--pool", type=int, default=1 << 18)
    args = ap.parse_args(argv)
    refused = stand_ins.refuse_without_card(args.device, ap.prog)
    if refused is not None:
        return refused
    scene, info = stand_ins.load(args.scene, args.width, args.height, device=args.device)
    stand_ins.describe(info)
    print_rows(profile(scene, pool=args.pool))
    return 0


if __name__ == "__main__":
    sys.exit(main())
