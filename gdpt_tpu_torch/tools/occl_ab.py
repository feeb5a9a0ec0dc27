"""A/B of the shadow (occluded) cast: full pool width against compacted.

Counterpart of tools/occl_ab.py: the NEE shadow rays of the captured pool
(cast, shaded, a light point sampled, thinned as nee_soa thins them: no
ray where the BSDF or the geometry term is zero), cast by occluded_soa
(a) at the pool's full width, as the render does, (b) compacted to the
live rays, bucketed to a power of two from 1,024 lanes, (c) and (d) the
same chained K times with the origins moved along the ray by 1e-7 (k + 1)
each step (the reference's anti-hoist nudge). (b)'s blocked flags must
equal (a)'s on every live ray. Each of (a)-(d) is timed as the
reference's stages (tools/profile_wavefront.timed); (c) and (d) run as one
function of K casts, captured as one CUDA graph on the card.

    python -m gdpt_tpu_torch.tools.occl_ab [scene] [--pool N] [--chain K]
        [--width W --height H] [--device cpu]

scene: a scene file or a preset of tools/stand_ins.py (default
icosphere_box: K3 any hit; cbox: K2).
"""

import argparse
import json
import sys

import torch

from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.tools import stand_ins
from gdpt_tpu_torch.tools.ab_dual_kernel import chain_ms
from gdpt_tpu_torch.tools.profile_nee import light_samples, pool_vertices
from gdpt_tpu_torch.tools.profile_wavefront import timed

DEFAULT_SCENE = "icosphere_box"


def shadow_rays(scene, pool=1 << 18, rays=None):
    """(origins, directions, tfar, live) of the pool's NEE shadow rays,
    thinned as the reference's occl_ab thins them; a thinned lane has
    tfar -1."""
    static = scene.static
    sc = ps.scene_soa_from_aos(scene)
    _, d, v, params = pool_vertices(scene, pool, rays)
    lu0, lu1, lw, lsw = light_samples(scene, v)
    ext = v.valid > 0
    _, p_l, n_l, _, is_env = ps.sample_light_point(static, sc, v.position, lu0, lu1, lw, lsw)
    to_l = p_l - v.position
    dist = soa.length(to_l)
    dl = soa.where(is_env, -1.0 * n_l, to_l * (1.0 / torch.clamp_min(dist, 1e-20)))
    f_nee = msoa.eval_bsdf_soa(params, -1.0 * d, dl, v.gn, v.frame,
                               static.used_material_kinds)
    g_area = torch.clamp_min(-soa.dot(dl, n_l), 0.0) / torch.clamp_min(dist * dist, 1e-20)
    g_geo = torch.where(is_env, 1.0, g_area)
    need = ext & (g_geo > 0) & (soa.vmax(f_nee) > 0)
    tfar = torch.where(is_env, BIG, (1.0 - static.shadow_epsilon) * dist)
    tfar = torch.where(need, tfar, -1.0)
    return v.position, dl, tfar, int((tfar > 0).sum())


def compact(pos, dl, tfar, live):
    """The live rays first (a stable sort of the dead flags), cut to the
    first power of two from 1,024 that holds them: (pos, dl, tfar, the
    lanes taken)."""
    order = torch.argsort((~(tfar > 0)).to(torch.int32), stable=True)
    width = 8 * 128
    while width < live:
        width *= 2
    sel = order[:width]
    return V3(*(c[sel] for c in pos)), V3(*(c[sel] for c in dl)), tfar[sel], sel


def ab(scene, pool=1 << 18, chain=8, reps=3, rays=None):
    """Rows (dicts): a "shadow" row (pool, live_shadow, width), then (a)-(d)
    (wall_ms, launches, device_ops, device_ms, hand_ms, hand_launches;
    Mrays/s over the live rays; ms a step for the chains), after (b)'s
    blocked flags were held equal to (a)'s on the live rays."""
    static = scene.static
    device = scene.device.camera.sample_to_cam.device
    sc = ps.scene_soa_from_aos(scene)
    eps = static.shadow_epsilon
    pos, dl, tfar, live = shadow_rays(scene, pool, rays)
    n = tfar.shape[0]
    posb, dlb, tfb, sel = compact(pos, dl, tfar, live)
    width = tfb.shape[0]
    rows = [{"label": "shadow", "pool": n, "live_shadow": live, "width": width}]

    def occ(p, dd, tf):
        return trs.occluded_soa(static, sc.geom, p, dd, eps, tf)

    full = occ(pos, dl, tfar)
    part = occ(posb, dlb, tfb)
    if not torch.equal(full[sel[:live]], part[:live]):
        bad = int((full[sel[:live]] != part[:live]).sum())
        raise AssertionError(f"compacted shadow cast differs on {bad} of {live} live rays")

    def chained(p0, dd, tf):
        acc = torch.zeros(tf.shape[0], dtype=REAL, device=tf.device)
        p = p0
        for k in range(chain):
            acc = acc + occ(p, dd, tf)
            p = p + dd * (1e-7 * (k + 1))
        return acc

    for label, fn, args, steps in (("a_full", occ, (pos, dl, tfar), 1),
                                   ("b_compacted", occ, (posb, dlb, tfb), 1),
                                   ("c_chained_full", chained, (pos, dl, tfar), chain),
                                   ("d_chained_compacted", chained, (posb, dlb, tfb), chain)):
        _, row = timed(fn, *args, device=device, reps=reps)
        if steps > 1:
            row["graph_ms"] = (chain_ms(lambda: fn(*args), 1, device, reps=reps)
                               if device.type == "cuda" else None)
        ms = row["graph_ms"] if row.get("graph_ms") is not None else row["wall_ms"]
        rows.append({"label": label, "lanes": args[2].shape[0], "steps": steps,
                     "ms_per_step": ms / steps, "mrays_live": live * steps / (ms * 1e-3) / 1e6,
                     **row})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.tools.occl_ab",
                                 description=__doc__.splitlines()[0])
    stand_ins.add_arguments(ap, DEFAULT_SCENE)
    ap.add_argument("--pool", type=int, default=1 << 18)
    ap.add_argument("--chain", type=int, default=8)
    args = ap.parse_args(argv)
    refused = stand_ins.refuse_without_card(args.device, ap.prog)
    if refused is not None:
        return refused
    scene, info = stand_ins.load(args.scene, args.width, args.height, device=args.device)
    stand_ins.describe(info)
    rows = ab(scene, pool=args.pool, chain=args.chain)
    sh = rows[0]
    print(f"pool={sh['pool']} live_shadow={sh['live_shadow']}", flush=True)
    for r in rows[1:]:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
