"""Unidirectional surface path tracer with NEE + power-heuristic MIS, the
per-ray oracle of the SoA `path` renders, lane-batched.

Counterpart of gdpt_tpu/integrators/path.py (reference:
src/path_tracing.h:13-348), with the reference's RNG streams (core/rng.py
reproduces jax.random bit for bit). The reference's vmap axis is the
leading dimension (one lane per (pixel, sample) ray, vectors (N, 3)); its
bounce while_loop is volpath._masked_loop, one host read a body counted
in volpath.HOST_READS["path"]. Casts go through ops/intersect.py to the
port's kernels (K1/K2, or K3/K4 on a BVH scene's packet table) for the
live lanes only, so the live rays cast equal the reference's per-lane
count of trace_path_stats.

Divergences from lajolla, on purpose and as the reference's:
- the MIS weight w2 is applied to BSDF-sampled *area light* hits as well
  (lajolla computes w2 but forgets to multiply at
  src/path_tracing.h:303-306; the envmap branch at :321-324 does apply it);
- when max_depth == -1 the loop is additionally capped at 64 bounces.
"""

import math

import torch

from gdpt_tpu_torch.core import math as gm
from gdpt_tpu_torch.core import rng
from gdpt_tpu_torch.core.distributions import pdf_2d
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.math import lift as L
from gdpt_tpu_torch.core.math import where as W
from gdpt_tpu_torch.integrators import volpath
from gdpt_tpu_torch.ops import intersect as isect
from gdpt_tpu_torch.ops import lights as lgt
from gdpt_tpu_torch.ops import materials as mat
from gdpt_tpu_torch.scene import camera as gcam

HARD_BOUNCE_CAP = 64


def max_bounce_iters(static) -> int:
    """Number of bounce-loop iterations (reference loop runs
    num_vertices = 3 .. max_depth + 1, src/path_tracing.h:85)."""
    md = static.options.max_depth
    return HARD_BOUNCE_CAP if md < 0 else max(md - 1, 0)


def nee_contribution(scene, static, casts, key, bounce, vertex, params, dir_view,
                     used_kinds, live=None):
    """Next-event estimation at a surface vertex with power-2 MIS
    (reference: src/path_tracing.h:115-227). Returns w1 * C1 / p1 (N, 3);
    the shadow ray is cast for the `live` lanes."""
    light_uv = rng.uniform(key, bounce, rng.SLOT_LIGHT_UV, (2,))
    light_w = rng.uniform(key, bounce, rng.SLOT_LIGHT_W)
    shape_w = rng.uniform(key, bounce, rng.SLOT_SHAPE_W)
    light_id = lgt.sample_light_id(scene, light_w)
    p_l, n_l = lgt.sample_point_on_light(
        scene, static, light_id, vertex.position, light_uv, shape_w)
    if static.has_envmap:
        is_env = light_id == static.envmap_light_id
    else:
        is_env = torch.zeros_like(light_w, dtype=torch.bool)
    to_light = p_l - vertex.position
    dist = gm.length(to_light)
    dir_area = to_light / L(torch.clamp_min(dist, 1e-20))
    dir_light = W(is_env, -n_l, dir_area)

    eps = static.shadow_epsilon
    tfar = torch.where(is_env, BIG, (1.0 - eps) * dist)
    blocked = isect.occluded(static, casts, vertex.position, dir_light, eps, tfar, live)
    g_area = torch.clamp_min(-gm.dot(dir_light, n_l), 0.0) / torch.clamp_min(dist * dist, 1e-20)
    g = torch.where(is_env, 1.0, g_area)
    g = torch.where(blocked, 0.0, g)

    p1 = lgt.light_pmf(scene, light_id) * lgt.pdf_point_on_light(
        scene, static, light_id, p_l, n_l, vertex.position)
    f = mat.eval_bsdf(params, dir_view, dir_light, vertex, used_kinds)
    radiance = lgt.emission_light(scene, static, light_id, -dir_light, 0.0, p_l, n_l)
    p2 = mat.pdf_bsdf(params, dir_view, dir_light, vertex, used_kinds) * g
    ok = (g > 0) & (p1 > 0)
    w1 = torch.where(ok, p1 * p1 / torch.clamp_min(p1 * p1 + p2 * p2, 1e-30), 0.0)
    c1 = L(g) * f * radiance / L(torch.clamp_min(p1, 1e-30))
    return W(ok, c1 * L(w1), 0.0)


def trace_path(scene, static, casts, x, y, key):
    """Radiance estimate (N, 3) for one sample of each lane's pixel (x, y)."""
    return trace_path_stats(scene, static, casts, x, y, key)[0]


def trace_path_stats(scene, static, casts, x, y, key):
    """Like trace_path but also returns each lane's number of rays cast
    (primary + shadow + scatter), for Mrays/s benchmarking."""
    w, h = static.width, static.height
    used = static.used_material_kinds
    n = x.shape[0]
    dev = x.device
    u_px = rng.uniform(key, 0, rng.SLOT_PIXEL, (2,))
    screen = torch.stack([(x + u_px[:, 0]) / w, (y + u_px[:, 1]) / h], dim=-1)
    org, d = gcam.sample_primary(
        scene.camera, w, h, static.filter_kind, static.filter_param, screen)
    radius0, spread0 = (t.to(dev) for t in gcam.init_ray_differential(w, h))
    vertex = isect.intersect(scene, static, casts, org, d, 0.0, BIG, None, radius0, spread0)

    # Primary miss: environment map or black
    # (reference: src/path_tracing.h:31-42).
    if static.has_envmap:
        miss_radiance = lgt.envmap_emission(scene, d, spread0)
    else:
        miss_radiance = 0.0
    radiance = W(vertex.valid, lgt.emission_at_vertex(scene, static, vertex, -d),
                 miss_radiance)

    ones = torch.ones(n, dtype=REAL, device=dev)
    n_iters = max_bounce_iters(static)
    if n_iters == 0:
        return radiance, ones

    state = dict(
        radiance=radiance,
        throughput=torch.ones(n, 3, dtype=REAL, device=dev),
        eta_scale=ones,
        d=d,
        spread=spread0.expand(n).clone(),
        vertex=vertex,
        active=vertex.valid,
        bounce=torch.zeros(n, dtype=INT, device=dev),
        rays=ones,
    )

    def cond(s):
        return s["active"] & (s["bounce"] < n_iters)

    def body(s, live):
        vertex = s["vertex"]
        bounce = s["bounce"]
        b = bounce + 1  # rng stream index; 0 is the camera sample
        dir_view = -s["d"]
        params = mat.gather_params(scene, static, vertex)

        # --- next event estimation ---
        rays = s["rays"]
        if static.n_lights > 0:
            nee = nee_contribution(scene, static, casts, key, b, vertex, params, dir_view,
                                   used, live)
            radiance = s["radiance"] + s["throughput"] * nee
            rays = rays + 1.0  # shadow ray
        else:
            radiance = s["radiance"]
        rays = rays + 1.0  # scatter ray

        # --- BSDF sampling (reference: src/path_tracing.h:232-345) ---
        uv_b = rng.uniform(key, b, rng.SLOT_BSDF_UV, (2,))
        w_b = rng.uniform(key, b, rng.SLOT_BSDF_W)
        samp = mat.sample_bsdf(params, dir_view, vertex, uv_b, w_b, used)
        active = s["active"] & samp.valid
        d_out = samp.dir_out

        is_transmit = samp.eta != 0
        eta_t = torch.where(is_transmit, samp.eta, 1.0)
        spread = torch.where(
            is_transmit,
            gcam.ray_diff_refract(vertex.ray_radius, s["spread"], vertex.mean_curvature,
                                  eta_t, samp.roughness),
            gcam.ray_diff_reflect(vertex.ray_radius, s["spread"], vertex.mean_curvature,
                                  samp.roughness),
        )
        eta_scale = torch.where(is_transmit, s["eta_scale"] / eta_t ** 2, s["eta_scale"])

        nxt = isect.intersect(scene, static, casts, vertex.position, d_out,
                              static.intersection_epsilon, BIG, live, vertex.ray_radius,
                              spread)
        dist2 = gm.distance_squared(nxt.position, vertex.position)
        g = torch.where(
            nxt.valid,
            torch.abs(gm.dot(d_out, nxt.geom_normal)) / torch.clamp_min(dist2, 1e-20),
            1.0,
        )
        f = mat.eval_bsdf(params, dir_view, d_out, vertex, used)
        p2 = mat.pdf_bsdf(params, dir_view, d_out, vertex, used)
        active = active & (p2 > 0)
        p2_area = p2 * g

        # Hit an emissive surface: MIS-weighted contribution.
        if static.n_lights > 0:
            hit_light_id = scene.shape_light_id[nxt.shape_id.long()]
            hit_light = nxt.valid & (hit_light_id >= 0)
            lid = torch.clamp_min(hit_light_id, 0)
            light_radiance = lgt.emission_at_vertex(scene, static, nxt, -d_out)
            p1 = lgt.light_pmf(scene, lid) * lgt.pdf_point_on_light(
                scene, static, lid, nxt.position, nxt.geom_normal, vertex.position)
            w2 = p2_area * p2_area / torch.clamp_min(p1 * p1 + p2_area * p2_area, 1e-30)
            c2 = L(g) * f * light_radiance / L(torch.clamp_min(p2_area, 1e-30))
            radiance = radiance + W(active & hit_light, s["throughput"] * c2 * L(w2), 0.0)
        if static.has_envmap:
            env_l = lgt.envmap_emission(scene, d_out, spread)
            env_uv, sin_e = lgt.envmap_uv_from_dir(scene, d_out)
            env_id = torch.full_like(bounce, static.envmap_light_id)
            p1e = lgt.light_pmf(scene, env_id) * torch.where(
                sin_e > 0,
                pdf_2d(scene.envmap.dist, env_uv)
                / torch.clamp_min(2.0 * math.pi * math.pi * sin_e, 1e-20),
                0.0,
            )
            w2e = p2_area * p2_area / torch.clamp_min(p1e * p1e + p2_area * p2_area, 1e-30)
            c2e = L(g) * f * env_l / L(torch.clamp_min(p2_area, 1e-30))
            radiance = radiance + W(active & ~nxt.valid, s["throughput"] * c2e * L(w2e), 0.0)

        active = active & nxt.valid

        # Russian roulette (reference: src/path_tracing.h:334-341).
        num_vertices = bounce + 3
        do_rr = (num_vertices - 1) >= static.options.rr_depth
        rr_prob = torch.where(
            do_rr, torch.clamp_max((s["throughput"] / L(eta_scale)).amax(dim=-1), 0.95), 1.0)
        u_rr = rng.uniform(key, b, rng.SLOT_RR)
        active = active & ((~do_rr) | (u_rr <= rr_prob))

        throughput = s["throughput"] * L(g) * f / L(torch.clamp_min(p2_area * rr_prob, 1e-30))
        throughput = W(active, throughput, s["throughput"])

        return dict(
            radiance=radiance,
            throughput=throughput,
            eta_scale=eta_scale,
            d=d_out,
            spread=spread,
            vertex=volpath._select(active, nxt, vertex),
            active=active,
            bounce=bounce + 1,
            rays=rays,
        )

    out = volpath._masked_loop(cond, body, state, "path")
    return out["radiance"], out["rays"]
