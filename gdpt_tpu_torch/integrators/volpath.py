"""Volumetric path tracing, the per-ray programs (versions 1-6), lane-batched.

Counterpart of gdpt_tpu/integrators/volpath.py (reference:
src/vol_path_tracing.h), rung for rung, with the reference's RNG streams
(core/rng.py reproduces jax.random bit for bit):

1. absorption-only homogeneous (reference: :9-36)
2. single scattering with one-sample NEE (reference: :40-155)
3. multi-bounce homogeneous, multi-medium, index-matched crossings
   (reference: :157-333)
4. + NEE <-> phase MIS with shadow rays through null surfaces
   (reference: :336-670)
5. + surface BSDF lighting inside media (reference: :672-1078)
6. (and 0) trace_volpath_final: chromatic heterogeneous null scattering
   (delta tracking) with ratio-tracked NEE (reference: :1085-1618), the
   per-ray oracle of integrators/volpath_soa.py

Each reference function is a per-ray program under jax.vmap; here the
vmap axis is the leading dimension of every tensor (one lane per
(pixel, sample) ray, vectors (N, 3)). Each lax.while_loop becomes a
masked loop: the body runs on all lanes, a lane keeps its new state only
while its own condition holds, and the loop ends when no lane's holds,
so the per-lane counters that key the RNG (b = iters + 1, and the inner
loops' iteration counters) stay the reference's. A nested loop starts
only on the lanes that are live in the body around it. Each loop
condition is one read on the host, counted in HOST_READS. Casts go
through ops/intersect.py to the port's kernels (K1/K2, or K3/K4 on a BVH
scene's packet table) for live lanes only. render.render takes
volpath_soa for versions 6 and 0 (supports_soa_volpath); trace_fn serves
every version to render.render_samples.
"""

import torch

from gdpt_tpu_torch.core import math as gm
from gdpt_tpu_torch.core import rng
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.math import lift as L
from gdpt_tpu_torch.core.math import where as W
from gdpt_tpu_torch.core.spectrum import avg
from gdpt_tpu_torch.ops import intersect as isect
from gdpt_tpu_torch.ops import lights as lgt
from gdpt_tpu_torch.ops import materials as mat
from gdpt_tpu_torch.ops import media as med
from gdpt_tpu_torch.scene import camera as gcam
from gdpt_tpu_torch.utils import profiling

HARD_CAP = 64
MAX_SHADOW_SEGMENTS = 16

# Host reads of a loop's condition, by loop: the bounce loop of versions
# 3-5 and of the final version, the shadow segments of versions 4-5 and
# of the final version, the final version's delta-tracking free flight
# ("flight") and ratio tracking along a shadow segment ("ratio"), and the
# bounce loops of integrators/path.py ("path") and gdpt.py ("gdpt").
# Counted by the renders; zeroed by the caller.
HOST_READS = profiling.counter_group("volpath.host_reads", {
    "bounce": 0, "segment": 0, "flight": 0, "ratio": 0, "path": 0, "gdpt": 0})


def _select(live, new, old):
    """W(live, new, old) over one state value: a tensor or a NamedTuple of
    tensors (a PathVertex). A value of k * N lanes (gdpt's offsets,
    offset-major) takes `live` repeated k times."""
    if isinstance(new, tuple):
        return type(new)(*(_select(live, a, b) for a, b in zip(new, old)))
    k = new.shape[0] // live.shape[0]
    return W(live.repeat(k) if k > 1 else live, new, old)


def _masked_loop(cond, body, state, loop):
    """lax.while_loop under vmap: body(state, live) on all lanes, the new
    state kept where the lane's cond held; ends when no lane's holds."""
    while True:
        live = cond(state)
        HOST_READS[loop] += 1
        if not bool(live.any()):
            return state
        new = body(state, live)
        state = {k: _select(live, new[k], state[k]) for k in state}


def _primary(scene, static, x, y, key):
    w, h = static.width, static.height
    u = rng.uniform(key, 0, rng.SLOT_PIXEL, (2,))
    screen = torch.stack([(x + u[:, 0]) / w, (y + u[:, 1]) / h], dim=-1)
    return gcam.sample_primary(
        scene.camera, w, h, static.filter_kind, static.filter_param, screen)


def _loop_cap(static):
    md = static.options.max_depth
    return HARD_CAP if md < 0 else min(md, HARD_CAP)


def _depth_stop(static, bounces):
    md = static.options.max_depth
    if md == -1:
        return torch.zeros_like(bounces, dtype=torch.bool)
    return bounces == md - 1


def _free_flight(key, b, sigma_t):
    """Exponential distance on channel 0 of the majorant."""
    u = rng.uniform(key, b, rng.SLOT_DISTANCE)
    return -torch.log(torch.clamp_min(1.0 - u, 1e-20)) / torch.clamp_min(sigma_t[:, 0], 1e-20)


# --------------------------------------------------------------------------
# Version 1: absorption only (reference: src/vol_path_tracing.h:9-36)
# --------------------------------------------------------------------------


def trace_volpath_1(scene, static, casts, x, y, key):
    org, d = _primary(scene, static, x, y, key)
    v = isect.intersect(scene, static, casts, org, d, 0.0, BIG)
    sigma_a = med.get_sigma_a(scene, static, v.exterior_medium_id, v.position)
    t_hit = gm.distance(v.position, org)
    trans = torch.exp(-sigma_a * L(t_hit))
    le = lgt.emission_at_vertex(scene, static, v, -d)
    return W(v.valid, trans * le, 0.0)


# --------------------------------------------------------------------------
# Version 2: single scattering (reference: src/vol_path_tracing.h:40-155)
# --------------------------------------------------------------------------


def _l_s1(scene, static, casts, key, p_sample, d, medium_id, live):
    """Single in-scattering estimate (reference helper L_s1, :40-88); the
    shadow ray is cast for the live lanes."""
    sigma_t = med.get_majorant(scene, static, medium_id, p_sample, d)
    light_uv = rng.uniform(key, 1, rng.SLOT_LIGHT_UV, (2,))
    light_w = rng.uniform(key, 1, rng.SLOT_LIGHT_W)
    shape_w = rng.uniform(key, 1, rng.SLOT_SHAPE_W)
    light_id = lgt.sample_light_id(scene, light_w)
    p_l, n_l = lgt.sample_point_on_light(scene, static, light_id, p_sample, light_uv, shape_w)
    pdf = lgt.light_pmf(scene, light_id) * lgt.pdf_point_on_light(
        scene, static, light_id, p_l, n_l, p_sample)
    diff = p_l - p_sample
    dist = torch.clamp_min(gm.length(diff), 1e-20)
    omega = diff / L(dist)
    rho = med.phase_eval(scene, static, medium_id, d, omega)
    le = lgt.emission_light(scene, static, light_id, -omega, 0.0, p_l, n_l)
    eps = static.shadow_epsilon
    blocked = isect.occluded(static, casts, p_sample, omega, eps, (1.0 - eps) * dist, live)
    jac = torch.abs(gm.dot(omega, n_l)) / (dist * dist)
    est = L(rho) * le * torch.exp(-sigma_t * L(dist)) * L(jac) * L(torch.where(blocked, 0.0, 1.0))
    return W(pdf > 0, est / L(torch.clamp_min(pdf, 1e-30)), 0.0)


def trace_volpath_2(scene, static, casts, x, y, key):
    org, d = _primary(scene, static, x, y, key)
    v = isect.intersect(scene, static, casts, org, d, 0.0, BIG)
    # Medium 0 fills the world in this rung (reference: :112-113).
    m0 = torch.zeros(org.shape[0], dtype=INT, device=org.device)
    u = rng.uniform(key, 1, rng.SLOT_DISTANCE)
    sigma_s = med.get_sigma_s(scene, static, m0, org)
    sigma_t = med.get_sigma_a(scene, static, m0, org) + sigma_s
    t = -torch.log(torch.clamp_min(1.0 - u, 1e-20)) / torch.clamp_min(sigma_t[:, 0], 1e-20)
    t_hit = gm.distance(v.position, org)
    t_max = torch.where(v.valid, t_hit, BIG)
    scatter = t < t_max

    # Scatter branch.
    p_scatter = org + L(t) * d
    ls1 = _l_s1(scene, static, casts, key, p_scatter, d, m0, scatter)
    scatter_val = sigma_s * ls1 / torch.clamp_min(sigma_t, 1e-20)

    # Surface branch: transmittance and pdf cancel.
    le = lgt.emission_at_vertex(scene, static, v, -d)
    return W(scatter, scatter_val, W(v.valid, le, 0.0))


# --------------------------------------------------------------------------
# Version 3: multi-bounce homogeneous (reference: src/vol_path_tracing.h:176-333)
# --------------------------------------------------------------------------


def _start_state(scene, static, x, y, key):
    org0, d0 = _primary(scene, static, x, y, key)
    n = org0.shape[0]
    dev = org0.device
    zi = torch.zeros(n, dtype=INT, device=dev)
    return dict(
        org=org0, d=d0,
        medium=zi + static.camera_medium_id,
        throughput=torch.ones(n, 3, dtype=REAL, device=dev),
        radiance=torch.zeros(n, 3, dtype=REAL, device=dev),
        bounces=zi,
        iters=zi,
        active=torch.ones(n, dtype=torch.bool, device=dev),
    )


def trace_volpath_3(scene, static, casts, x, y, key):
    cap = _loop_cap(static)
    eps_isect = static.intersection_epsilon

    def cond(s):
        return s["active"] & (s["iters"] < cap + 1)

    def body(s, live):
        b = s["iters"] + 1
        v = isect.intersect(scene, static, casts, s["org"], s["d"], 0.0, BIG, live)
        in_medium = s["medium"] >= 0

        sigma_t = med.get_majorant(scene, static, s["medium"], s["org"], s["d"])
        t = _free_flight(key, b, sigma_t)
        t_hit = gm.distance(v.position, s["org"])
        t_max = torch.where(v.valid, t_hit, BIG)
        scatter = in_medium & (t < t_max)

        trans = W(in_medium, torch.exp(-sigma_t * L(torch.where(scatter, t, t_hit))), 1.0)
        trans_pdf = W(in_medium, W(scatter, trans * sigma_t, trans), 1.0)
        alive = in_medium | v.valid
        new_org = W(scatter, s["org"] + L(t) * s["d"], v.position + s["d"] * eps_isect)
        throughput = s["throughput"] * trans / torch.clamp_min(trans_pdf, 1e-30)

        # Surface emission when not scattering (reference: :263-270).
        le = lgt.emission_at_vertex(scene, static, v, -s["d"])
        radiance = s["radiance"] + W(alive & ~scatter & v.valid, throughput * le, 0.0)

        depth_stop = _depth_stop(static, s["bounces"])
        passthrough = (~scatter) & v.valid & (v.material_id == -1) & ~depth_stop
        new_medium = torch.where(passthrough, med.update_medium(v, s["d"], s["medium"]),
                                 s["medium"])

        # Scatter: phase sampling (reference: :293-307).
        uv_p = rng.uniform(key, b, rng.SLOT_PHASE_UV, (2,))
        new_dir = med.phase_sample(scene, static, s["medium"], -s["d"], uv_p)
        rho = med.phase_eval(scene, static, s["medium"], -s["d"], new_dir)
        pdf_p = med.phase_pdf(scene, static, s["medium"], -s["d"], new_dir)
        sigma_s = med.get_sigma_s(scene, static, s["medium"], new_org)
        throughput_sc = throughput * L(rho / torch.clamp_min(pdf_p, 1e-30)) * sigma_s

        do_scatter = alive & scatter & ~depth_stop
        throughput = W(do_scatter, throughput_sc, throughput)
        new_d = W(do_scatter, new_dir, s["d"])

        active = alive & ~depth_stop & (do_scatter | passthrough)

        # Russian roulette (reference: :315-329; channel-0 heuristic).
        do_rr = active & (s["bounces"] >= static.options.rr_depth) & do_scatter
        rr_prob = torch.where(do_rr, torch.clamp_max(throughput[:, 0], 0.95), 1.0)
        u_rr = rng.uniform(key, b, rng.SLOT_RR)
        killed = do_rr & (u_rr >= rr_prob)
        throughput = W(do_rr & ~killed, throughput / L(rr_prob), throughput)
        active = active & ~killed

        return dict(
            org=W(active | ~alive, new_org, s["org"]),
            d=new_d,
            medium=new_medium,
            throughput=throughput,
            radiance=radiance,
            bounces=s["bounces"] + (do_scatter | passthrough).to(INT),
            iters=s["iters"] + 1,
            active=s["active"] & active,
        )

    state = _start_state(scene, static, x, y, key)
    return _masked_loop(cond, body, state, "bounce")["radiance"]


# --------------------------------------------------------------------------
# Shared volumetric NEE (versions 4/5; reference: :336-451, :672-788)
# --------------------------------------------------------------------------


def _nee_vol(scene, static, casts, key, b, p0, og_dir, medium, bounces, live,
             surface=None):
    """NEE from a scattering point (surface=None: phase MIS) or from a
    surface vertex (surface=(params, vertex, used): BSDF MIS), the shadow
    ray marching through index-matched surfaces. live: the lanes whose
    estimate is used; only they cast."""
    light_uv = rng.uniform(key, b, rng.SLOT_LIGHT_UV, (2,))
    light_w = rng.uniform(key, b, rng.SLOT_LIGHT_W)
    shape_w = rng.uniform(key, b, rng.SLOT_SHAPE_W)
    light_id = lgt.sample_light_id(scene, light_w)
    p_l, n_l = lgt.sample_point_on_light(scene, static, light_id, p0, light_uv, shape_w)
    pdf_nee = lgt.light_pmf(scene, light_id) * lgt.pdf_point_on_light(
        scene, static, light_id, p_l, n_l, p0)
    dir_light = gm.normalize(p_l - p0, eps=1e-20)
    max_depth = static.options.max_depth
    eps = static.shadow_epsilon
    n = p0.shape[0]
    dev = p0.device

    state = dict(
        p=p0,
        t_light=torch.ones(n, 3, dtype=REAL, device=dev),
        p_trans=torch.ones(n, dtype=REAL, device=dev),
        shadow_medium=medium,
        shadow_bounces=torch.zeros(n, dtype=INT, device=dev),
        alive=live,
        blocked=torch.zeros(n, dtype=torch.bool, device=dev),
        seg=torch.zeros(n, dtype=INT, device=dev),
    )

    def cond(s):
        return s["alive"] & (s["seg"] < MAX_SHADOW_SEGMENTS)

    def body(s, seg_live):
        dist_left = gm.distance(p_l, s["p"])
        sv = isect.intersect(scene, static, casts, s["p"], dir_light, eps,
                             (1.0 - eps) * dist_left, seg_live)
        next_t = torch.where(sv.valid, gm.distance(s["p"], sv.position), dist_left)
        in_med = s["shadow_medium"] >= 0
        sigma_t = med.get_majorant(scene, static, s["shadow_medium"], s["p"], dir_light)
        t_light = W(in_med, s["t_light"] * torch.exp(-sigma_t * L(next_t)), s["t_light"])
        p_trans = torch.where(in_med, s["p_trans"] * torch.exp(-sigma_t[:, 0] * next_t),
                              s["p_trans"])

        clear = ~sv.valid
        hit_solid = sv.valid & (sv.material_id >= 0)
        sb = s["shadow_bounces"] + 1
        if max_depth != -1:
            depth_kill = (bounces + sb + 1) >= max_depth
        else:
            depth_kill = torch.zeros_like(clear)
        blocked = s["blocked"] | hit_solid | (sv.valid & ~hit_solid & depth_kill)
        alive = s["alive"] & ~clear & ~blocked
        new_medium = torch.where(
            alive, med.update_medium(sv, dir_light, s["shadow_medium"]), s["shadow_medium"])
        new_p = W(alive, s["p"] + L(next_t) * dir_light, s["p"])
        return dict(p=new_p, t_light=t_light, p_trans=p_trans, shadow_medium=new_medium,
                    shadow_bounces=sb, alive=alive, blocked=blocked, seg=s["seg"] + 1)

    out = _masked_loop(cond, body, state, "segment")
    visible = ~out["blocked"] & (out["t_light"].amax(dim=-1) > 0)

    diff = p_l - p0
    dist = torch.clamp_min(gm.length(diff), 1e-20)
    omega = diff / L(dist)
    g = torch.clamp_min(-gm.dot(omega, n_l), 0.0) / (dist * dist)
    le = lgt.emission_light(scene, static, light_id, -omega, 0.0, p_l, n_l)
    if surface is None:
        rho = L(med.phase_eval(scene, static, medium, og_dir, omega))
        pdf_dir = med.phase_pdf(scene, static, medium, og_dir, omega) * g * out["p_trans"]
    else:
        params, vertex, used = surface
        rho = mat.eval_bsdf(params, og_dir, omega, vertex, used)
        pdf_dir = mat.pdf_bsdf(params, og_dir, omega, vertex, used) * g * out["p_trans"]
    contrib = out["t_light"] * L(g) * rho * le / L(torch.clamp_min(pdf_nee, 1e-30))
    w = pdf_nee * pdf_nee / torch.clamp_min(pdf_nee * pdf_nee + pdf_dir * pdf_dir, 1e-30)
    ok = visible & (pdf_nee > 0)
    return W(ok, contrib * L(w), 0.0)


# --------------------------------------------------------------------------
# Versions 4 & 5 (reference: :458-670 and :794-1078)
# --------------------------------------------------------------------------


def _trace_volpath_45(scene, static, casts, x, y, key, surface_lighting: bool):
    cap = _loop_cap(static)
    used = static.used_material_kinds
    eps_isect = static.intersection_epsilon

    state = _start_state(scene, static, x, y, key)
    n = state["org"].shape[0]
    dev = state["org"].device
    state.update(
        dir_pdf=torch.zeros(n, dtype=REAL, device=dev),
        nee_cache=torch.zeros(n, 3, dtype=REAL, device=dev),
        multi_trans_pdf=torch.ones(n, dtype=REAL, device=dev),
        never_scatter=torch.ones(n, dtype=torch.bool, device=dev),
        never_surface=torch.ones(n, dtype=torch.bool, device=dev),
    )

    def cond(s):
        return s["active"] & (s["iters"] < cap + 1)

    def body(s, live):
        b = s["iters"] + 1
        v = isect.intersect(scene, static, casts, s["org"], s["d"], 0.0, BIG, live)
        in_medium = s["medium"] >= 0

        sigma_t = med.get_majorant(scene, static, s["medium"], s["org"], s["d"])
        t = _free_flight(key, b, sigma_t)
        t_hit = gm.distance(v.position, s["org"])
        t_max = torch.where(v.valid, t_hit, BIG)
        scatter = in_medium & (t < t_max)

        trans = W(in_medium, torch.exp(-sigma_t * L(torch.where(scatter, t, t_hit))), 1.0)
        trans_pdf = W(in_medium, W(scatter, trans * sigma_t, trans), 1.0)
        alive = in_medium | v.valid
        scatter_pos = s["org"] + L(t) * s["d"]
        new_org = W(scatter, scatter_pos, v.position)
        throughput = s["throughput"] * trans / torch.clamp_min(trans_pdf, 1e-30)
        multi_trans_pdf = s["multi_trans_pdf"] * trans_pdf[:, 0]

        # Emission on a surface hit, MIS-weighted when a phase/BSDF sample
        # led here (reference: :550-595, :893-940).
        shape_light = scene.shape_light_id[v.shape_id.long()]
        hit_light = alive & ~scatter & v.valid & (shape_light >= 0)
        le = lgt.emission_at_vertex(scene, static, v, -s["d"])
        fresh = s["never_scatter"]
        if surface_lighting:
            fresh = fresh & s["never_surface"]
        lid = torch.clamp_min(shape_light, 0)
        pdf_nee = lgt.light_pmf(scene, lid) * lgt.pdf_point_on_light(
            scene, static, lid, v.position, v.geom_normal, s["nee_cache"])
        diff = v.position - s["nee_cache"]
        ndist = torch.clamp_min(gm.length(diff), 1e-20)
        omega = diff / L(ndist)
        g = torch.clamp_min(-gm.dot(omega, v.geom_normal), 0.0) / (ndist * ndist)
        dir_pdf_total = s["dir_pdf"] * multi_trans_pdf * g
        w_mis = dir_pdf_total * dir_pdf_total / torch.clamp_min(
            dir_pdf_total * dir_pdf_total + pdf_nee * pdf_nee, 1e-30)
        radiance = s["radiance"] + W(
            hit_light, throughput * le * L(torch.where(fresh, 1.0, w_mis)), 0.0)

        depth_stop = _depth_stop(static, s["bounces"])
        passthrough = alive & (~scatter) & v.valid & (v.material_id == -1) & ~depth_stop
        new_medium = torch.where(passthrough, med.update_medium(v, s["d"], s["medium"]),
                                 s["medium"])

        # --- scattering vertex: NEE + phase sampling (reference: :616-645) ---
        do_scatter = alive & scatter & ~depth_stop
        sigma_s = med.get_sigma_s(scene, static, s["medium"], new_org)
        nee = _nee_vol(scene, static, casts, key, b, new_org, -s["d"], s["medium"],
                       s["bounces"], live & do_scatter)
        radiance = radiance + W(do_scatter, throughput * sigma_s * nee, 0.0)
        uv_p = rng.uniform(key, b, rng.SLOT_PHASE_UV, (2,))
        new_dir = med.phase_sample(scene, static, s["medium"], -s["d"], uv_p)
        rho = med.phase_eval(scene, static, s["medium"], -s["d"], new_dir)
        pdf_p = med.phase_pdf(scene, static, s["medium"], -s["d"], new_dir)
        thr_scatter = throughput * L(rho / torch.clamp_min(pdf_p, 1e-30)) * sigma_s

        # --- surface vertex (version 5 only; reference: :992-1057) ---
        if surface_lighting:
            do_surface = alive & ~scatter & v.valid & (v.material_id >= 0) & ~depth_stop
            params = mat.gather_params(scene, static, v)
            nee_s = _nee_vol(scene, static, casts, key, b, v.position, -s["d"], s["medium"],
                             s["bounces"], live & do_surface, surface=(params, v, used))
            radiance = radiance + W(do_surface, throughput * nee_s, 0.0)
            uv_b = rng.uniform(key, b, rng.SLOT_BSDF_UV, (2,))
            w_b = rng.uniform(key, b, rng.SLOT_BSDF_W)
            samp = mat.sample_bsdf(params, -s["d"], v, uv_b, w_b, used)
            f = mat.eval_bsdf(params, -s["d"], samp.dir_out, v, used)
            p2 = mat.pdf_bsdf(params, -s["d"], samp.dir_out, v, used)
            surf_ok = do_surface & samp.valid & (p2 > 0)
            thr_surface = throughput * f / L(torch.clamp_min(p2, 1e-30))
            refract_medium = med.update_medium(v, s["d"], s["medium"])
            new_medium = torch.where(surf_ok & (samp.eta != 0), refract_medium, new_medium)
        else:
            do_surface = torch.zeros_like(alive)
            surf_ok = do_surface
            p2 = s["dir_pdf"]
            thr_surface = throughput

        throughput = W(do_scatter, thr_scatter, W(surf_ok, thr_surface, throughput))
        new_d = W(do_scatter, new_dir, s["d"])
        if surface_lighting:
            new_d = W(surf_ok, samp.dir_out, new_d)
        new_org = W(do_scatter | surf_ok, new_org + new_d * eps_isect,
                    W(passthrough, new_org + s["d"] * eps_isect, new_org))
        dir_pdf = torch.where(do_scatter, pdf_p, torch.where(surf_ok, p2, s["dir_pdf"]))
        nee_cache = W(do_scatter, scatter_pos, W(do_surface, v.position, s["nee_cache"]))
        never_scatter = s["never_scatter"] & ~do_scatter
        never_surface = s["never_surface"] & ~surf_ok
        mtp = torch.where(do_scatter | surf_ok, 1.0, multi_trans_pdf)

        active = alive & ~depth_stop & (do_scatter | passthrough | surf_ok)

        do_rr = active & (s["bounces"] >= static.options.rr_depth) & ~passthrough
        rr_prob = torch.where(do_rr, torch.clamp_max(throughput.amax(dim=-1), 0.95), 1.0)
        u_rr = rng.uniform(key, b, rng.SLOT_RR)
        killed = do_rr & (u_rr > rr_prob)
        throughput = W(do_rr & ~killed, throughput / L(rr_prob), throughput)
        active = active & ~killed

        return dict(
            org=new_org,
            d=new_d,
            medium=new_medium,
            throughput=throughput,
            radiance=radiance,
            bounces=s["bounces"] + active.to(INT),
            iters=s["iters"] + 1,
            dir_pdf=dir_pdf,
            nee_cache=nee_cache,
            multi_trans_pdf=mtp,
            never_scatter=never_scatter,
            never_surface=never_surface,
            active=s["active"] & active,
        )

    return _masked_loop(cond, body, state, "bounce")["radiance"]


def trace_volpath_4(scene, static, casts, x, y, key):
    return _trace_volpath_45(scene, static, casts, x, y, key, surface_lighting=False)


def trace_volpath_5(scene, static, casts, x, y, key):
    return _trace_volpath_45(scene, static, casts, x, y, key, surface_lighting=True)


# --------------------------------------------------------------------------
# Final version: chromatic heterogeneous null scattering
# (reference: src/vol_path_tracing.h:1085-1618)
# --------------------------------------------------------------------------


def _channel(key, b, slot, it=None):
    """A uniform channel pick in {0, 1, 2} per lane, as an index (N, 1)."""
    u = rng.uniform(key, b, slot) if it is None else rng.loop_uniform(key, b, slot, it)
    return torch.clamp((u * 3.0).to(INT), 0, 2).long()[:, None]


def _delta_flight(scene, static, key, b, org, d, medium, t_hit, live):
    """Delta-tracking free flight with the max_null_collisions cap
    (reference: :1334-1403), for the live lanes. Returns (scatter,
    travel_t, transmittance, trans_dir_pdf, trans_nee_pdf)."""
    sigma_m = med.get_majorant(scene, static, medium, org, d)
    channel = _channel(key, b, rng.SLOT_CHANNEL)
    sig_ch = sigma_m.gather(1, channel)[:, 0]
    max_m = torch.clamp_min(sigma_m.amax(dim=-1), 1e-20)
    max_iters = static.options.max_null_collisions
    n = org.shape[0]
    dev = org.device
    ones3 = torch.ones(n, 3, dtype=REAL, device=dev)

    state = dict(
        accum_t=torch.zeros(n, dtype=REAL, device=dev),
        it=torch.zeros(n, dtype=INT, device=dev),
        scatter=torch.zeros(n, dtype=torch.bool, device=dev),
        trans=ones3, p_dir=ones3, p_nee=ones3,
        alive=live & (sig_ch > 0),
    )

    def cond(s):
        return s["alive"] & (s["it"] < max_iters)

    def body(s, _):
        u = rng.loop_uniform(key, b, rng.SLOT_NULL_LOOP, s["it"])
        u2 = rng.loop_uniform(key, b, rng.SLOT_NULL_LOOP + 1, s["it"])
        t = -torch.log(torch.clamp_min(1.0 - u, 1e-20)) / torch.clamp_min(sig_ch, 1e-20)
        dt = t_hit - s["accum_t"]
        accum_t = torch.minimum(s["accum_t"] + t, t_hit)
        reach_surface = t >= dt

        # Reached the surface: close out transmittance (reference: :1390-1397).
        e_srf = torch.exp(-sigma_m * L(dt))
        trans_srf = s["trans"] * e_srf
        pdir_srf = s["p_dir"] * e_srf
        pnee_srf = s["p_nee"] * e_srf

        # Collision inside the medium: real or null particle.
        point = org + L(accum_t) * d
        sigma_t = (med.get_sigma_a(scene, static, medium, point)
                   + med.get_sigma_s(scene, static, medium, point))
        real_prob = sigma_t / torch.clamp_min(sigma_m, 1e-20)
        is_real = u2 < real_prob.gather(1, channel)[:, 0]
        e = torch.exp(-sigma_m * L(t))
        mm = L(max_m)
        trans_real = s["trans"] * e / mm
        pdir_real = s["p_dir"] * e * sigma_m * real_prob / mm
        trans_null = s["trans"] * e * (sigma_m - sigma_t) / mm
        pdir_null = s["p_dir"] * e * sigma_m * (1.0 - real_prob) / mm
        pnee_null = s["p_nee"] * e * sigma_m / mm

        scatter = ~reach_surface & is_real
        return dict(
            accum_t=accum_t, it=s["it"] + 1, scatter=s["scatter"] | scatter,
            trans=W(reach_surface, trans_srf, W(is_real, trans_real, trans_null)),
            p_dir=W(reach_surface, pdir_srf, W(is_real, pdir_real, pdir_null)),
            p_nee=W(reach_surface, pnee_srf, W(is_real, s["p_nee"], pnee_null)),
            alive=s["alive"] & ~reach_surface & ~scatter,
        )

    out = _masked_loop(cond, body, state, "flight")
    no_medium = sigma_m.amax(dim=-1) <= 0
    return (
        out["scatter"] & ~no_medium,
        torch.where(out["scatter"], out["accum_t"], t_hit),
        W(no_medium, 1.0, out["trans"]),
        W(no_medium, 1.0, out["p_dir"]),
        W(no_medium, 1.0, out["p_nee"]),
    )


def _nee_vol_final(scene, static, casts, key, b, p0, og_dir, medium, bounces, live,
                   surface=None):
    """NEE with ratio-tracked transmittance (reference: :1085-1279): the
    shadow ray crosses up to MAX_SHADOW_SEGMENTS index-matched surfaces,
    each segment in a medium ratio-tracked up to max_null_collisions
    times. live: the lanes whose estimate is used; only they cast and
    track."""
    light_uv = rng.uniform(key, b, rng.SLOT_LIGHT_UV, (2,))
    light_w = rng.uniform(key, b, rng.SLOT_LIGHT_W)
    shape_w = rng.uniform(key, b, rng.SLOT_SHAPE_W)
    light_id = lgt.sample_light_id(scene, light_w)
    p_l, n_l = lgt.sample_point_on_light(scene, static, light_id, p0, light_uv, shape_w)
    pdf_nee_pt = lgt.light_pmf(scene, light_id) * lgt.pdf_point_on_light(
        scene, static, light_id, p_l, n_l, p0)
    dir_light = gm.normalize(p_l - p0, eps=1e-20)
    max_depth = static.options.max_depth
    eps = static.shadow_epsilon
    max_iters = static.options.max_null_collisions
    n = p0.shape[0]
    dev = p0.device
    ones3 = torch.ones(n, 3, dtype=REAL, device=dev)
    zi = torch.zeros(n, dtype=INT, device=dev)

    state = dict(
        p=p0, t_light=ones3, p_trans_nee=ones3, p_trans_dir=ones3,
        shadow_medium=medium, shadow_bounces=zi, alive=live,
        blocked=torch.zeros(n, dtype=torch.bool, device=dev), seg=zi,
    )

    def cond(s):
        return s["alive"] & (s["seg"] < MAX_SHADOW_SEGMENTS)

    def body(s, seg_live):
        dist_left = gm.distance(p_l, s["p"])
        sv = isect.intersect(scene, static, casts, s["p"], dir_light, eps,
                             (1.0 - eps) * dist_left, seg_live)
        next_t = torch.where(sv.valid, gm.distance(s["p"], sv.position), dist_left)
        in_med = s["shadow_medium"] >= 0
        sigma_m = med.get_majorant(scene, static, s["shadow_medium"], s["p"], dir_light)
        channel = _channel(key, b, rng.SLOT_NEE_LOOP, s["seg"])
        sig_ch = sigma_m.gather(1, channel)[:, 0]
        mm = L(torch.clamp_min(sigma_m.amax(dim=-1), 1e-20))

        inner = dict(
            accum_t=torch.zeros(n, dtype=REAL, device=dev), it=zi, p=s["p"],
            t_light=s["t_light"], p_nee=s["p_trans_nee"], p_dir=s["p_trans_dir"],
            alive=seg_live & in_med & (sig_ch > 0),
        )

        def icond(i):
            return i["alive"] & (i["it"] < max_iters)

        def ibody(i, _):
            u = rng.loop_uniform(key, b, rng.SLOT_NEE_LOOP + 1, s["seg"] * 4096 + i["it"])
            t = -torch.log(torch.clamp_min(1.0 - u, 1e-20)) / torch.clamp_min(sig_ch, 1e-20)
            dt = next_t - i["accum_t"]
            accum_t = torch.minimum(i["accum_t"] + t, next_t)
            reach = t >= dt
            new_p_in = i["p"] + L(t) * dir_light
            sigma_t = (med.get_sigma_a(scene, static, s["shadow_medium"], new_p_in)
                       + med.get_sigma_s(scene, static, s["shadow_medium"], new_p_in))
            real_prob = sigma_t / torch.clamp_min(sigma_m, 1e-20)
            e = torch.exp(-sigma_m * L(t))
            tl_in = i["t_light"] * e * (sigma_m - sigma_t) / mm
            pn_in = i["p_nee"] * e * sigma_m / mm
            pd_in = i["p_dir"] * e * sigma_m * (1.0 - real_prob) / mm
            e_srf = torch.exp(-sigma_m * L(dt))
            t_light = W(reach, i["t_light"] * e_srf, tl_in)
            return dict(
                accum_t=accum_t, it=i["it"] + 1,
                p=W(reach, i["p"] + L(dt) * dir_light, new_p_in),
                t_light=t_light,
                p_nee=W(reach, i["p_nee"] * e_srf, pn_in),
                p_dir=W(reach, i["p_dir"] * e_srf, pd_in),
                alive=i["alive"] & ~reach & ~(t_light.amax(dim=-1) <= 0),
            )

        iout = _masked_loop(icond, ibody, inner, "ratio")
        clear = ~sv.valid
        hit_solid = sv.valid & (sv.material_id >= 0)
        sb = s["shadow_bounces"] + 1
        if max_depth != -1:
            depth_kill = (bounces + sb + 1) >= max_depth
        else:
            depth_kill = torch.zeros_like(clear)
        blocked = s["blocked"] | hit_solid | (sv.valid & ~hit_solid & depth_kill)
        alive = s["alive"] & ~clear & ~blocked
        return dict(
            p=W(alive, sv.position, s["p"]),
            t_light=W(in_med, iout["t_light"], s["t_light"]),
            p_trans_nee=W(in_med, iout["p_nee"], s["p_trans_nee"]),
            p_trans_dir=W(in_med, iout["p_dir"], s["p_trans_dir"]),
            shadow_medium=torch.where(
                alive, med.update_medium(sv, dir_light, s["shadow_medium"]),
                s["shadow_medium"]),
            shadow_bounces=sb, alive=alive, blocked=blocked, seg=s["seg"] + 1,
        )

    out = _masked_loop(cond, body, state, "segment")
    visible = ~out["blocked"] & (out["t_light"].amax(dim=-1) > 0)

    pdf_nee = pdf_nee_pt * avg(out["p_trans_nee"])
    diff = p_l - p0
    dist = torch.clamp_min(gm.length(diff), 1e-20)
    omega = diff / L(dist)
    g = torch.clamp_min(-gm.dot(omega, n_l), 0.0) / (dist * dist)
    le = lgt.emission_light(scene, static, light_id, -omega, 0.0, p_l, n_l)
    if surface is None:
        rho = L(med.phase_eval(scene, static, medium, og_dir, omega))
        pdf_dir = (med.phase_pdf(scene, static, medium, og_dir, omega) * g
                   * avg(out["p_trans_dir"]))
    else:
        params, vertex, used = surface
        rho = mat.eval_bsdf(params, og_dir, omega, vertex, used)
        pdf_dir = mat.pdf_bsdf(params, og_dir, omega, vertex, used) * g * avg(out["p_trans_dir"])
    contrib = out["t_light"] * L(g) * rho * le / L(torch.clamp_min(pdf_nee, 1e-30))
    w = pdf_nee * pdf_nee / torch.clamp_min(pdf_nee * pdf_nee + pdf_dir * pdf_dir, 1e-30)
    ok = visible & (pdf_nee > 0)
    return W(ok, contrib * L(w), 0.0)


def trace_volpath_final(scene, static, casts, x, y, key):
    """Versions 6 and 0: delta-tracking free flight, ratio-tracked NEE
    from scattering points and surfaces, MIS against phase and BSDF
    sampling (reference: src/vol_path_tracing.h:1085-1618)."""
    max_depth = static.options.max_depth
    cap = _loop_cap(static)
    used = static.used_material_kinds
    eps_isect = static.intersection_epsilon

    state = _start_state(scene, static, x, y, key)
    n = state["org"].shape[0]
    dev = state["org"].device
    ones3 = torch.ones(n, 3, dtype=REAL, device=dev)
    state.update(
        dir_pdf=torch.zeros(n, dtype=REAL, device=dev),
        nee_cache=torch.zeros(n, 3, dtype=REAL, device=dev),
        multi_trans_pdf=ones3,
        multi_trans_nee=ones3,
        never_scatter=torch.ones(n, dtype=torch.bool, device=dev),
        never_surface=torch.ones(n, dtype=torch.bool, device=dev),
    )

    def cond(s):
        return s["active"] & (s["iters"] < cap + 1)

    def body(s, live):
        b = s["iters"] + 1
        v = isect.intersect(scene, static, casts, s["org"], s["d"], 0.0, BIG, live)
        in_medium = s["medium"] >= 0
        t_hit = torch.where(v.valid, gm.distance(v.position, s["org"]), BIG)

        scatter, travel_t, trans, p_dir, p_nee = _delta_flight(
            scene, static, key, b, s["org"], s["d"], s["medium"], t_hit, live)
        scatter = scatter & in_medium
        trans = W(in_medium, trans, 1.0)
        p_dir = W(in_medium, p_dir, 1.0)
        p_nee = W(in_medium, p_nee, 1.0)

        alive = in_medium | v.valid
        new_org = W(scatter, s["org"] + L(travel_t) * s["d"], W(v.valid, v.position, s["org"]))
        throughput = s["throughput"] * trans / L(torch.clamp_min(avg(p_dir), 1e-30))
        multi_trans_pdf = s["multi_trans_pdf"] * p_dir
        multi_trans_nee = s["multi_trans_nee"] * p_nee

        shape_light = scene.shape_light_id[v.shape_id.long()]
        hit_light = alive & ~scatter & v.valid & (shape_light >= 0)
        le = lgt.emission_at_vertex(scene, static, v, -s["d"])
        fresh = s["never_scatter"] & s["never_surface"]
        lid = torch.clamp_min(shape_light, 0)
        pdf_nee = lgt.light_pmf(scene, lid) * lgt.pdf_point_on_light(
            scene, static, lid, v.position, v.geom_normal, s["nee_cache"]) * avg(multi_trans_nee)
        diff = v.position - s["nee_cache"]
        ndist = torch.clamp_min(gm.length(diff), 1e-20)
        omega = diff / L(ndist)
        g = torch.clamp_min(-gm.dot(omega, v.geom_normal), 0.0) / (ndist * ndist)
        dir_pdf_total = s["dir_pdf"] * avg(multi_trans_pdf) * g
        w_mis = dir_pdf_total * dir_pdf_total / torch.clamp_min(
            dir_pdf_total * dir_pdf_total + pdf_nee * pdf_nee, 1e-30)
        radiance = s["radiance"] + W(
            hit_light, throughput * le * L(torch.where(fresh, 1.0, w_mis)), 0.0)

        depth_stop = _depth_stop(static, s["bounces"])
        passthrough = alive & (~scatter) & v.valid & (v.material_id == -1) & ~depth_stop
        new_medium = torch.where(passthrough, med.update_medium(v, s["d"], s["medium"]),
                                 s["medium"])
        # Offset along the normal on pass-through (reference: :1486-1487).
        pass_dir = W(gm.dot(s["d"], v.geom_normal) > 0, v.geom_normal, -v.geom_normal)

        # --- scattering vertex: NEE + phase sampling ---
        do_scatter = alive & scatter & ~depth_stop
        sigma_s = med.get_sigma_s(scene, static, s["medium"], new_org)
        nee = _nee_vol_final(scene, static, casts, key, b, new_org, -s["d"], s["medium"],
                             s["bounces"], live & do_scatter)
        radiance = radiance + W(do_scatter, throughput * sigma_s * nee, 0.0)
        uv_p = rng.uniform(key, b, rng.SLOT_PHASE_UV, (2,))
        new_dir = med.phase_sample(scene, static, s["medium"], -s["d"], uv_p)
        rho = med.phase_eval(scene, static, s["medium"], -s["d"], new_dir)
        pdf_p = med.phase_pdf(scene, static, s["medium"], -s["d"], new_dir)
        thr_scatter = throughput * L(rho / torch.clamp_min(pdf_p, 1e-30)) * sigma_s

        # --- surface vertex: NEE + BSDF sampling ---
        do_surface = alive & ~scatter & v.valid & (v.material_id >= 0) & ~depth_stop
        params = mat.gather_params(scene, static, v)
        nee_s = _nee_vol_final(scene, static, casts, key, b, v.position, -s["d"], s["medium"],
                               s["bounces"], live & do_surface, surface=(params, v, used))
        radiance = radiance + W(do_surface, throughput * nee_s, 0.0)
        uv_b = rng.uniform(key, b, rng.SLOT_BSDF_UV, (2,))
        w_b = rng.uniform(key, b, rng.SLOT_BSDF_W)
        samp = mat.sample_bsdf(params, -s["d"], v, uv_b, w_b, used)
        f = mat.eval_bsdf(params, -s["d"], samp.dir_out, v, used)
        p2 = mat.pdf_bsdf(params, -s["d"], samp.dir_out, v, used)
        surf_ok = do_surface & samp.valid & (p2 > 0)
        thr_surface = throughput * f / L(torch.clamp_min(p2, 1e-30))
        refract_medium = med.update_medium(v, s["d"], s["medium"])
        new_medium = torch.where(surf_ok & (samp.eta != 0), refract_medium, new_medium)

        throughput = W(do_scatter, thr_scatter, W(surf_ok, thr_surface, throughput))
        new_d = W(do_scatter, new_dir, W(surf_ok, samp.dir_out, s["d"]))
        new_org = W(do_scatter | surf_ok, new_org + new_d * eps_isect,
                    W(passthrough, new_org + pass_dir * eps_isect, new_org))
        dir_pdf = torch.where(do_scatter, pdf_p, torch.where(surf_ok, p2, s["dir_pdf"]))
        nee_cache = W(do_scatter | do_surface, new_org, s["nee_cache"])
        reset = do_scatter | surf_ok
        mtp = W(reset, 1.0, multi_trans_pdf)
        mtn = W(reset, 1.0, multi_trans_nee)

        active = alive & ~depth_stop & (do_scatter | passthrough | surf_ok)
        do_rr = active & (s["bounces"] >= static.options.rr_depth) & ~passthrough
        rr_prob = torch.where(do_rr, torch.clamp_max(throughput.amax(dim=-1), 0.95), 1.0)
        u_rr = rng.uniform(key, b, rng.SLOT_RR)
        killed = do_rr & (u_rr > rr_prob)
        throughput = W(do_rr & ~killed, throughput / L(rr_prob), throughput)
        active = active & ~killed

        return dict(
            org=new_org, d=new_d, medium=new_medium, throughput=throughput,
            radiance=radiance,
            bounces=s["bounces"] + active.to(INT),
            iters=s["iters"] + 1,
            dir_pdf=dir_pdf, nee_cache=nee_cache,
            multi_trans_pdf=mtp, multi_trans_nee=mtn,
            never_scatter=s["never_scatter"] & ~do_scatter,
            never_surface=s["never_surface"] & ~surf_ok,
            active=s["active"] & active,
        )

    return _masked_loop(cond, body, state, "bounce")["radiance"]


_VERSIONS = {
    1: trace_volpath_1,
    2: trace_volpath_2,
    3: trace_volpath_3,
    4: trace_volpath_4,
    5: trace_volpath_5,
    6: trace_volpath_final,
    0: trace_volpath_final,
}


def trace_fn(static):
    """Select the integrator rung (reference: src/render.cpp:127-140)."""
    return _VERSIONS[static.options.vol_path_version]
