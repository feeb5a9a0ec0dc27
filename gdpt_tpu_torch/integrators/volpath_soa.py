"""Batched (SoA) volumetric path tracing on tensors.

Counterpart of gdpt_tpu/integrators/volpath_soa.py, the production rung
(vol_path_version 6 / 0) of the volumetric integrator: chromatic
heterogeneous null scattering (reference: src/vol_path_tracing.h:
1085-1618), with the same RNG streams and counters, so that the port is
held against the reference pixel by pixel.

Loop nesting mirrors the reference: an outer bounce loop, a
delta-tracking free-flight loop, and a two-level shadow march (segments
across null surfaces x null collisions inside a segment). In eager torch
each loop's condition is a read on the host; HOST_READS counts them.
The inner loops hold a vec3 as one (3, N) tensor (ops/media_soa.py's row
forms): the reference's operations in its order, in a third of the
launches.

Brute-force scenes run the banded loop (`trace_volpath_soa`, all lanes
of a pass in lockstep), BVH scenes the wavefront lane pool
(`_vol_wavefront_accum`); both call the one bounce, `_vol_bounce`, whose
RNG streams depend only on (pixel, sample, bounce, slot), so the two
drivers give the same estimate; a checkpointed render resumes on the
banded loop (integrators/banded.py), and a sharded one (mesh=,
parallel/sharding.py) runs the banded loop with its rays split over the
mesh's devices. The banded sample reads loop conditions on the host, so
it runs eagerly, never as a captured graph. The wavefront
can keep its pool morton-sorted (pool_sort=True, _vol_pool_sort). The
rungs 1-5 are integrators/volpath.py.
"""

import numpy as np
import torch

from gdpt_tpu_torch.accel import packet_kernels
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import banded
from gdpt_tpu_torch.integrators import gdpt_soa as gs
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.integrators import vertex_soa as vx
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.ops import media_soa as meds
from gdpt_tpu_torch.scene.build import Scene
from gdpt_tpu_torch.utils import profiling

HARD_CAP = 64
MAX_SHADOW_SEGMENTS = 16

# Per-bounce RNG slots (shared stride with path_soa's counters).
_C_LIGHT_UV = 1
_C_LIGHT_W = 2
_C_BSDF_UV = 3
_C_BSDF_W = 4
_C_CHANNEL = 5
_C_PHASE_UV = 6
_C_RR = 7
# Loop-uniform counter blocks (disjoint from the per-bounce block).
_BLK_FLIGHT = 0x40000000
_BLK_NEE_CH = 0x50000000
_BLK_NEE_IT = 0x60000000

# Host reads of a loop's condition, by loop: the bounce loop of the
# banded driver, free flight, the shadow segments, the null collisions
# within a segment. Counted by the renders; zeroed by the caller.
HOST_READS = profiling.counter_group("volpath_soa.host_reads",
                                     {"bounce": 0, "flight": 0, "segment": 0, "collision": 0})


def supports_soa_volpath(scene: Scene) -> bool:
    return (
        scene.static.options.vol_path_version in (0, 6)
        and msoa.supports_soa_materials(scene)
    )


def _avg(v: V3):
    return (v.x + v.y + v.z) * (1.0 / 3.0)


def _avg3(r):
    return (r[0] + r[1] + r[2]) * (1.0 / 3.0)


def _chan3(r, channel):
    """Row `channel` (an int64 (N,) tensor of 0, 1, 2) of the (3, N) r."""
    return r.gather(0, channel[None])[0]


def _vmax3(r):
    return torch.maximum(torch.maximum(r[0], r[1]), r[2])


def _any(mask, loop):
    HOST_READS[loop] += 1
    return bool(mask.any())


def _loop_cap(static):
    md = static.options.max_depth
    return HARD_CAP if md < 0 else min(md, HARD_CAP)


def _vol_bounce(static, sc: ps.SceneSoA, media, seed, s, pool_sort=False):
    """One volumetric bounce over a lane dict with per-lane bounce
    indices (s["it"]) and per-lane (pixel, sample) RNG identity, shared
    by the banded loop (lanes in lockstep) and the wavefront pool (lanes
    at mixed depths) (reference hot loop: src/vol_path_tracing.h:
    1309-1614). seed is a Python int; s["active"] a bool mask. pool_sort:
    the pool is morton-sorted (_vol_pool_sort), so the main cast skips
    its own sort."""
    used = static.used_material_kinds
    max_depth = static.options.max_depth
    max_null = static.options.max_null_collisions
    cap = _loop_cap(static)
    active = s["active"]
    n = active.shape[0]
    dev = active.device
    zero = torch.zeros(n, dtype=REAL, device=dev)
    zero3 = V3(zero, zero, zero)
    one3 = V3(zero + 1.0, zero + 1.0, zero + 1.0)
    eps = static.shadow_epsilon
    eps_isect = static.intersection_epsilon
    pixel = s["pixel"]
    sample = s["sample"]
    b = s["it"].to(torch.int64) + 1  # per lane; counters in int64, masked to 32 bits

    # The sample index rides its own RNG input word, so the loop blocks'
    # counters never alias across samples.
    uni2 = soa.Streams(seed, pixel, sample)

    def bounce_uni2(slot):
        return uni2(b * ps._CTR_STRIDE + slot)

    def channel_of(u):
        return torch.clamp((u * 3.0).to(torch.int64), 0, 2)

    def free_flight(org, d, medium, t_hit, live):
        """Delta tracking (reference: src/vol_path_tracing.h:1334-1403).
        Returns (scatter, travel_t, trans, p_dir, p_nee). Lanes outside
        `live` (retired ones, whose results are discarded) take no step:
        the loop then stops as soon as the live lanes do, with the same
        results for them."""
        o3, d3 = soa.stack(org), soa.stack(d)
        sigma_m = meds.majorant3(media, static, medium, o3, d3)
        u_ch, _ = bounce_uni2(_C_CHANNEL)
        channel = channel_of(u_ch)
        sig_m_ch = _chan3(sigma_m, channel)
        sig_ch = torch.clamp_min(sig_m_ch, 1e-20)
        inv_max = 1.0 / torch.clamp_min(_vmax3(sigma_m), 1e-20)
        sig_safe = torch.clamp_min(sigma_m, 1e-20)
        accum_t = zero
        scatter = torch.zeros(n, dtype=torch.bool, device=dev)
        trans = torch.ones((3, n), dtype=REAL, device=dev)
        p_dir, p_nee = trans, trans
        alive = live & (sig_m_ch > 0)
        it = 0
        while it < max_null and _any(alive, "flight"):
            u, u2 = uni2(_BLK_FLIGHT + b * 2048 + it)
            t = -torch.log(torch.clamp_min(1.0 - u, 1e-20)) / sig_ch
            dt = t_hit - accum_t
            acc_new = torch.minimum(accum_t + t, t_hit)
            reach = t >= dt
            e_dt = torch.exp(-sigma_m * dt)
            e_t = torch.exp(-sigma_m * t)
            sa, ss = meds.sigmas3(media, static, medium, o3 + d3 * acc_new)
            sigma_t = sa + ss
            real_prob = sigma_t / sig_safe
            is_real = u2 < _chan3(real_prob, channel)
            tr_t, pd_t = trans * e_t, p_dir * e_t
            trans_n = torch.where(reach, trans * e_dt, torch.where(
                is_real, tr_t * inv_max, tr_t * (sigma_m - sigma_t) * inv_max))
            p_dir_n = torch.where(reach, p_dir * e_dt, torch.where(
                is_real, pd_t * sigma_m * real_prob * inv_max,
                pd_t * sigma_m * (1.0 - real_prob) * inv_max))
            p_nee_n = torch.where(reach, p_nee * e_dt, torch.where(
                is_real, p_nee, p_nee * e_t * sigma_m * inv_max))
            scatter_now = ~reach & is_real
            accum_t = torch.where(alive, acc_new, accum_t)
            scatter = scatter | (alive & scatter_now)
            trans = torch.where(alive, trans_n, trans)
            p_dir = torch.where(alive, p_dir_n, p_dir)
            p_nee = torch.where(alive, p_nee_n, p_nee)
            alive = alive & ~reach & ~scatter_now
            it += 1
        no_medium = _vmax3(sigma_m) <= 0
        return (
            scatter & ~no_medium,
            torch.where(scatter, accum_t, t_hit),
            torch.where(no_medium, 1.0, trans),
            torch.where(no_medium, 1.0, p_dir),
            torch.where(no_medium, 1.0, p_nee),
        )

    def nee_vol(p0: V3, og_dir: V3, medium, bounces, do_mask, surface=None):
        """NEE with ratio-tracked transmittance (reference:
        src/vol_path_tracing.h:1085-1279). Returns the masked
        contribution and the traced-shadow-ray mask (f32)."""
        lu0, lu1 = bounce_uni2(_C_LIGHT_UV)
        lw, lsw = bounce_uni2(_C_LIGHT_W)
        light_id, p_l, n_l, pdf_pt, _ = vx.sample_light_point(
            static, sc, p0, lu0, lu1, lw, lsw)
        pdf_nee_pt = soa.take(sc.light_pmf, light_id) * pdf_pt
        to_l = p_l - p0
        dist_full = torch.clamp_min(soa.length(to_l), 1e-20)
        dir_light = to_l * (1.0 / dist_full)
        # Zero-contribution skip (estimator-identical): a zero phase or
        # BSDF factor, backfacing or zero emission, or a zero light pdf
        # make the term zero whatever the transmittance, so those lanes
        # skip the shadow march (their contribution is selected to
        # exactly zero below either way). The factors are the ones the
        # contribution uses.
        g_num = torch.clamp_min(-soa.dot(dir_light, n_l), 0.0)
        le = soa.where(soa.dot(n_l, -1.0 * dir_light) > 0,
                       soa.gather(sc.light_intensity, light_id), zero3)
        if surface is None:
            rho_s = meds.phase_eval_soa(media, static, medium, og_dir, dir_light)
            rho_max = rho_s
        else:
            params, v = surface
            rho = msoa.eval_bsdf_soa(params, og_dir, dir_light, v.gn, v.frame, used)
            rho_max = soa.vmax(rho)
        do_mask = (do_mask & (pdf_nee_pt > 0) & (g_num > 0)
                   & (soa.vmax(le) > 0) & (rho_max > 0))

        dl3 = soa.stack(dir_light)
        p = p0
        t_light = torch.ones((3, n), dtype=REAL, device=dev)
        p_nee, p_dir = t_light, t_light
        shadow_medium = medium
        shadow_bounces = torch.zeros(n, dtype=INT, device=dev)
        alive = do_mask
        blocked = torch.zeros(n, dtype=torch.bool, device=dev)
        seg = 0
        while seg < MAX_SHADOW_SEGMENTS and _any(alive, "segment"):
            dist_left = soa.length(p_l - p)
            sv_hit, sv_gn = trs.intersect_soa_gn(
                static, sc.geom, p, dir_light, eps, torch.where(alive, BIG, -1.0))
            sv = ps.shade_hit(static, sc, p, dir_light, sv_hit, sv_gn)
            in_range = sv_hit.t < (1.0 - eps) * dist_left
            sv_valid = (sv.valid > 0) & in_range
            next_t = torch.where(sv_valid, soa.length(sv.position - p), dist_left)
            in_med = shadow_medium >= 0
            p3 = soa.stack(p)
            sigma_m = meds.majorant3(media, static, shadow_medium, p3, dl3)
            u_ch, _ = uni2(_BLK_NEE_CH + b * 64 + seg)
            channel = channel_of(u_ch)
            sig_m_ch = _chan3(sigma_m, channel)
            sig_ch = torch.clamp_min(sig_m_ch, 1e-20)
            inv_max = 1.0 / torch.clamp_min(_vmax3(sigma_m), 1e-20)
            sig_safe = torch.clamp_min(sigma_m, 1e-20)
            accum_t = zero
            ip, tl, pn, pd = p3, t_light, p_nee, p_dir
            ialive = alive & in_med & (sig_m_ch > 0)
            it = 0
            while it < max_null and _any(ialive, "collision"):
                u, _ = uni2(_BLK_NEE_IT + (b * 16 + seg) * 2048 + it)
                t = -torch.log(torch.clamp_min(1.0 - u, 1e-20)) / sig_ch
                dt = next_t - accum_t
                acc_new = torch.minimum(accum_t + t, next_t)
                reach = t >= dt
                new_p_in = ip + dl3 * t
                sa, ss = meds.sigmas3(media, static, shadow_medium, new_p_in)
                sigma_t = sa + ss
                e_t = torch.exp(-sigma_m * t)
                e_dt = torch.exp(-sigma_m * dt)
                real_prob = sigma_t / sig_safe
                tl_n = torch.where(reach, tl * e_dt, tl * e_t * (sigma_m - sigma_t) * inv_max)
                pn_n = torch.where(reach, pn * e_dt, pn * e_t * sigma_m * inv_max)
                pd_n = torch.where(reach, pd * e_dt,
                                   pd * e_t * sigma_m * (1.0 - real_prob) * inv_max)
                p_new = torch.where(reach, ip + dl3 * dt, new_p_in)
                dead = _vmax3(tl_n) <= 0
                accum_t = torch.where(ialive, acc_new, accum_t)
                ip = torch.where(ialive, p_new, ip)
                tl = torch.where(ialive, tl_n, tl)
                pn = torch.where(ialive, pn_n, pn)
                pd = torch.where(ialive, pd_n, pd)
                ialive = ialive & ~reach & ~dead
                it += 1
            upd = alive & in_med
            t_light = torch.where(upd, tl, t_light)
            p_nee = torch.where(upd, pn, p_nee)
            p_dir = torch.where(upd, pd, p_dir)

            hit_solid = sv_valid & (sv.material_id >= 0)
            shadow_bounces = shadow_bounces + alive.to(INT)
            blocked_now = hit_solid
            if max_depth != -1:
                depth_kill = (bounces + shadow_bounces + 1) >= max_depth
                blocked_now = hit_solid | (sv_valid & ~hit_solid & depth_kill)
            blocked = blocked | (alive & blocked_now)
            alive = alive & sv_valid & ~blocked_now
            int_med = soa.take(sc.shape_interior_medium, sv.shape_id)
            ext_med = soa.take(sc.shape_exterior_medium, sv.shape_id)
            shadow_medium = torch.where(
                alive,
                meds.update_medium_soa(int_med, ext_med, dir_light, sv.gn, shadow_medium),
                shadow_medium)
            p = soa.where(alive, sv.position, p)
            seg += 1
        visible = ~blocked & (_vmax3(t_light) > 0)

        pdf_nee = pdf_nee_pt * _avg3(p_nee)
        g = g_num / (dist_full * dist_full)
        if surface is None:
            rho = V3(rho_s, rho_s, rho_s)
            pdf_dir = rho_s * g * _avg3(p_dir)
        else:
            pdf_dir = msoa.pdf_bsdf_soa(
                params, og_dir, dir_light, v.gn, v.frame, used) * g * _avg3(p_dir)
        contrib = soa.unstack(t_light) * le * (g / torch.clamp_min(pdf_nee, 1e-30)) * rho
        w = pdf_nee * pdf_nee / torch.clamp_min(pdf_nee * pdf_nee + pdf_dir * pdf_dir, 1e-30)
        ok = visible & (pdf_nee > 0) & do_mask
        # Second output: the traced-shadow-ray mask, keeping ray counts
        # exact under the zero-contribution skip.
        return soa.where(ok, contrib * w, zero3), do_mask.to(REAL)

    # Inactive lanes become dead rays (tfar < tnear): the casts skip them.
    org, d, medium = s["org"], s["d"], s["medium"]
    hit, gn_raw = trs.intersect_soa_gn(static, sc.geom, org, d, 0.0,
                                       torch.where(active, BIG, -1.0), sort_rays=not pool_sort)
    v = ps.shade_hit(static, sc, org, d, hit, gn_raw)
    v_ok = v.valid > 0
    in_medium = medium >= 0
    t_hit = torch.where(v_ok, soa.length(v.position - org), BIG)
    rays = s["rays"] + active.to(REAL).sum()

    scatter, travel_t, trans, p_dir, p_nee = free_flight(org, d, medium, t_hit, active)
    scatter = scatter & in_medium
    trans = soa.unstack(torch.where(in_medium, trans, 1.0))
    p_dir = soa.unstack(torch.where(in_medium, p_dir, 1.0))
    p_nee = soa.unstack(torch.where(in_medium, p_nee, 1.0))

    alive = (in_medium | v_ok) & active
    new_org = soa.where(scatter, org + d * travel_t, soa.where(v_ok, v.position, org))
    throughput = s["throughput"] * trans * (1.0 / torch.clamp_min(_avg(p_dir), 1e-30))
    multi_trans_pdf = s["multi_trans_pdf"] * p_dir
    multi_trans_nee = s["multi_trans_nee"] * p_nee

    # Emission with MIS against the NEE of the last scatter or surface
    # vertex (nee_cache).
    hit_light = alive & ~scatter & v_ok & (v.light_id >= 0)
    le = ps.emission(sc, v, -1.0 * d)
    fresh = s["never_scatter"] & s["never_surface"]
    dist2c = soa.length_squared(v.position - s["nee_cache"])
    p1c = ps.hit_light_pdf_soa(static, sc, s["nee_cache"], v, d, dist2c)
    pdf_nee = p1c * _avg(multi_trans_nee)
    diff = v.position - s["nee_cache"]
    ndist = torch.clamp_min(soa.length(diff), 1e-20)
    omega = diff * (1.0 / ndist)
    g = torch.clamp_min(-soa.dot(omega, v.gn), 0.0) / (ndist * ndist)
    dir_pdf_total = s["dir_pdf"] * _avg(multi_trans_pdf) * g
    w_mis = dir_pdf_total * dir_pdf_total / torch.clamp_min(
        dir_pdf_total * dir_pdf_total + pdf_nee * pdf_nee, 1e-30)
    radiance = s["radiance"] + soa.where(
        hit_light, throughput * le * torch.where(fresh, 1.0, w_mis), zero3)

    # Null surfaces: pass through, crossing into the medium behind.
    if max_depth != -1:
        depth_stop = s["bounces"] == max_depth - 1
    else:
        depth_stop = torch.zeros_like(active)
    passthrough = alive & ~scatter & v_ok & (v.material_id == -1) & ~depth_stop
    int_med = soa.take(sc.shape_interior_medium, v.shape_id)
    ext_med = soa.take(sc.shape_exterior_medium, v.shape_id)
    new_medium = torch.where(
        passthrough, meds.update_medium_soa(int_med, ext_med, d, v.gn, medium), medium)
    pass_dir = soa.where(soa.dot(d, v.gn) > 0, v.gn, -1.0 * v.gn)

    # Medium scatter: NEE, then a phase-sampled direction.
    do_scatter = alive & scatter & ~depth_stop
    sigma_s = soa.unstack(meds.sigmas3(media, static, medium, soa.stack(new_org))[1])
    if static.n_lights > 0:
        nee, shadow_m1 = nee_vol(new_org, -1.0 * d, medium, s["bounces"], do_scatter)
        radiance = radiance + soa.where(do_scatter, throughput * sigma_s * nee, zero3)
    pu0, pu1 = bounce_uni2(_C_PHASE_UV)
    new_dir = meds.phase_sample_soa(media, static, medium, -1.0 * d, pu0, pu1)
    rho = meds.phase_eval_soa(media, static, medium, -1.0 * d, new_dir)
    pdf_p = rho  # phase_pdf_soa is phase_eval_soa
    thr_scatter = throughput * (rho / torch.clamp_min(pdf_p, 1e-30)) * sigma_s

    # Surface vertex: NEE, then a BSDF-sampled direction.
    do_surface = alive & ~scatter & v_ok & (v.material_id >= 0) & ~depth_stop
    params = msoa.gather_params_soa(
        sc.mat_tables, used, v.material_id, v.uv_u, v.uv_v, static.spec_image_slots,
        float_tex_slots=static.float_tex_slots)
    if static.n_lights > 0:
        nee_s, shadow_m2 = nee_vol(v.position, -1.0 * d, medium, s["bounces"], do_surface,
                                   surface=(params, v))
        radiance = radiance + soa.where(do_surface, throughput * nee_s, zero3)
        rays = rays + shadow_m1.sum() + shadow_m2.sum()
    bu0, bu1 = bounce_uni2(_C_BSDF_UV)
    w_lobe, _ = bounce_uni2(_C_BSDF_W)
    samp = msoa.sample_bsdf_soa(params, -1.0 * d, v.gn, v.frame, bu0, bu1, w_lobe, used)
    f = msoa.eval_bsdf_soa(params, -1.0 * d, samp.dir_out, v.gn, v.frame, used)
    p2 = msoa.pdf_bsdf_soa(params, -1.0 * d, samp.dir_out, v.gn, v.frame, used)
    surf_ok = (samp.valid > 0) & (p2 > 0)
    thr_surface = throughput * f * (1.0 / torch.clamp_min(p2, 1e-30))
    refract_medium = meds.update_medium_soa(int_med, ext_med, d, v.gn, medium)
    surf_moved = do_surface & surf_ok
    new_medium = torch.where(surf_moved & (samp.eta != 0), refract_medium, new_medium)

    throughput = soa.where(do_scatter, thr_scatter,
                           soa.where(surf_moved, thr_surface, throughput))
    new_d = soa.where(do_scatter, new_dir, soa.where(surf_moved, samp.dir_out, d))
    moved = do_scatter | surf_moved
    new_org = soa.where(moved, new_org + new_d * eps_isect,
                        soa.where(passthrough, new_org + pass_dir * eps_isect, new_org))
    dir_pdf = torch.where(do_scatter, pdf_p, torch.where(surf_moved, p2, s["dir_pdf"]))
    nee_cache = soa.where(do_scatter | do_surface, new_org, s["nee_cache"])
    mtp = soa.where(moved, one3, multi_trans_pdf)
    mtn = soa.where(moved, one3, multi_trans_nee)
    never_scatter = s["never_scatter"] & ~do_scatter
    never_surface = s["never_surface"] & ~surf_moved

    # Per-lane iteration cap: a lane runs at most cap + 1 bounce bodies,
    # so pooled lanes at mixed depths each get the banded loop's budget.
    active_next = alive & ~depth_stop & (moved | passthrough)
    active_next = active_next & (s["it"] + 1 < cap + 1)
    do_rr = active_next & (s["bounces"] >= static.options.rr_depth) & ~passthrough
    rr_prob = torch.where(do_rr, torch.clamp_max(soa.vmax(throughput), 0.95), 1.0)
    _, u_rr = bounce_uni2(_C_RR)
    killed = do_rr & (u_rr > rr_prob)
    throughput = soa.where(do_rr & ~killed, throughput * (1.0 / rr_prob), throughput)
    active_next = active_next & ~killed

    upd = active  # only lanes that entered this iteration advance
    return dict(
        pixel=pixel,
        sample=sample,
        org=soa.where(upd, new_org, org),
        d=soa.where(upd, new_d, d),
        medium=torch.where(upd, new_medium, medium),
        throughput=soa.where(upd, throughput, s["throughput"]),
        radiance=radiance,
        bounces=s["bounces"] + (upd & active_next).to(INT),
        it=s["it"] + upd.to(INT),
        dir_pdf=torch.where(upd, dir_pdf, s["dir_pdf"]),
        nee_cache=soa.where(upd, nee_cache, s["nee_cache"]),
        multi_trans_pdf=soa.where(upd, mtp, s["multi_trans_pdf"]),
        multi_trans_nee=soa.where(upd, mtn, s["multi_trans_nee"]),
        never_scatter=torch.where(upd, never_scatter, s["never_scatter"]),
        never_surface=torch.where(upd, never_surface, s["never_surface"]),
        active=active & active_next,
        rays=rays,
    )


def _init_vol_lanes(static, camera, pixel, sample, seed):
    """Fresh per-lane volumetric path state for (pixel, sample) items
    (int64 tensors of uint32 values); RNG identical to the banded
    driver's primary set-up (bounce-0 _CTR_PIXEL counter)."""
    n = pixel.shape[0]
    dev = pixel.device
    zero = torch.zeros(n, dtype=REAL, device=dev)
    zero3 = V3(zero, zero, zero)
    one3 = V3(zero + 1.0, zero + 1.0, zero + 1.0)
    yes = torch.ones(n, dtype=torch.bool, device=dev)
    xs = (pixel % static.width).to(REAL)
    ys = (pixel // static.width).to(REAL)
    u0, u1 = soa.uniform2(seed, pixel, ps._CTR_PIXEL, sample)
    org0, d0 = ps.primary_rays_soa(static, camera, xs, ys, u0, u1)
    return dict(
        pixel=pixel,
        sample=sample,
        org=org0, d=d0,
        medium=torch.full((n,), static.camera_medium_id, dtype=INT, device=dev),
        throughput=one3,
        radiance=zero3,
        bounces=torch.zeros(n, dtype=INT, device=dev),
        it=torch.zeros(n, dtype=INT, device=dev),
        dir_pdf=zero,
        nee_cache=zero3,
        multi_trans_pdf=one3,
        multi_trans_nee=one3,
        never_scatter=yes,
        never_surface=yes,
        active=yes,
    )


def trace_volpath_soa(static, camera, sc: ps.SceneSoA, media, ray_idx, seed, sample0):
    """One volumetric path sample per lane; returns (radiance V3, rays as
    an f32 0-d tensor). Banded driver: all lanes start at bounce 0 in
    lockstep and the loop runs until every lane dies (the per-lane
    iteration caps bound it). ray_idx: the linear pixel indices; seed
    and sample0 are Python ints (uint32 values)."""
    n = ray_idx.shape[0]
    cap = _loop_cap(static)
    pixel = ray_idx.to(torch.int64)
    sample = torch.full((n,), int(sample0) & ps._M32, dtype=torch.int64, device=pixel.device)
    state = _init_vol_lanes(static, camera, pixel, sample, seed)
    state["rays"] = torch.tensor(1.0 * n, dtype=REAL, device=pixel.device)
    giter = 0
    while giter < cap + 1 and _any(state["active"], "bounce"):
        state = _vol_bounce(static, sc, media, seed, state)
        giter += 1
    return state["radiance"], state["rays"]


def _vol_wavefront_body(static, camera, sc, media, st, pool_sort=False):
    """One wavefront iteration: harvest finished lanes into the
    per-pixel accumulator, refill them with the next (pixel, sample) work
    items, then run the shared volumetric bounce.

    The pool keeps about every lane on useful work where the banded loop
    pays full-width free-flight and shadow-march cost while its live
    lanes decay (reference inner loop: src/vol_path_tracing.h:1343-1403).
    The refill rule reads the dead-lane count on the host (where the
    reference branches on the device with lax.cond); the work queue's
    position is a Python int. st["acc"] is updated in place."""
    s = st["lane"]
    n_pix = static.width * static.height
    dead = ~s["active"]
    pending = st["pending"]
    harvest = dead & pending

    r = s["radiance"]
    upd = torch.stack([torch.where(harvest, c, 0.0) for c in (r.x, r.y, r.z)], dim=1)
    st["acc"].index_add_(0, s["pixel"], upd)

    pah = pending & ~harvest
    pool = dead.shape[0]
    n_dead = int(dead.sum())
    next_item, total = st["next_item"], st["total"]
    # Quarter-pool refill gate: the refill's primary-ray regeneration is
    # a full-width cost whether 1 lane or 100k lanes issue, so it
    # amortizes over >= pool/4 fresh paths per trigger.
    if n_dead * 4 >= pool and next_item < total:
        rank = torch.cumsum(dead.to(torch.int64), dim=0) - 1
        item = next_item + torch.where(dead, rank, 0)
        issue = dead & (item < total)
        new_pixel = torch.where(issue, item % n_pix, s["pixel"])
        new_sample = torch.where(issue, item // n_pix, s["sample"])
        fresh = _init_vol_lanes(static, camera, new_pixel, new_sample, st["seed"])
        n_issue = min(n_dead, total - next_item)
        lane = soa.tree_where(issue, fresh, {k: s[k] for k in fresh})
        # Banded ray-count convention: primaries counted at lane init.
        lane["rays"] = s["rays"] + float(n_issue)
        pending2 = issue | pah
        next_item = next_item + n_issue
    else:
        lane, pending2 = dict(s), pah
    lane = _vol_bounce(static, sc, media, st["seed"], lane, pool_sort)
    return dict(st, lane=lane, pending=pending2, next_item=next_item,
                occ_sum=st["occ_sum"] + lane["active"].to(REAL).mean(),
                iters=st["iters"] + 1)


def _vol_pool_sort(st, tab):
    """Morton-permute the volumetric lane pool by its rays (see
    gdpt_soa._sort_lane_pool)."""
    s = st["lane"]
    return gs._sort_lane_pool(st, tab, s["org"], s["d"], s["active"])


def _vol_wavefront_state(static, camera, total, seed, pool):
    """The wavefront's state before its first iteration: an all-dead
    lane pool of `pool` lanes, the work queue at item 0 of `total`, a
    zeroed (n_pix, 3) accumulator."""
    device = camera.sample_to_cam.device
    n_pix = static.width * static.height
    seed = int(seed) & ps._M32
    zeros_u = torch.zeros(pool, dtype=torch.int64, device=device)
    lane0 = _init_vol_lanes(static, camera, zeros_u, zeros_u, seed)
    lane0["active"] = torch.zeros(pool, dtype=torch.bool, device=device)  # refilled from the queue
    lane0["rays"] = torch.tensor(0.0, dtype=REAL, device=device)
    return dict(
        lane=lane0,
        acc=torch.zeros((n_pix, 3), dtype=REAL, device=device),
        pending=torch.zeros(pool, dtype=torch.bool, device=device),
        next_item=0,
        total=total,
        seed=seed,
        occ_sum=torch.tensor(0.0, dtype=REAL, device=device),
        iters=0,
    )


def _vol_wavefront_accum(static, camera, sc, media, spp, seed, n_pix, k_iters=6,
                         pool=1 << 17, compact=True, pool_sort=False):
    """Run the volumetric wavefront to completion; returns (acc (3,
    n_pix) f64 sample sums, total rays). pool: the lane-pool width asked
    for (cut to the work, in whole dispatch quanta); compact: tail
    compaction; pool_sort: morton-sort the pool before every chunk of
    k_iters iterations (BVH scenes only; _vol_pool_sort). The iteration
    count, mean occupancy and last pool width of the last run are left
    in _vol_wavefront_accum.last_iters, .last_occupancy and .last_pool."""
    total = n_pix * spp
    if total >= 2 ** 32:
        raise ValueError(
            f"volpath wavefront work queue: n_pix*spp = {total} >= 2^32; "
            "use the banded loop for renders this large")
    lane_q = ps.LANE_QUANTUM
    pool = ps._pool_width(total, pool)
    st = _vol_wavefront_state(static, camera, total, seed, pool)
    # The f32 device accumulator drains into host f64 every ~64 issued
    # spp-equivalents (see path_soa.render_soa_wavefront).
    host_acc = np.zeros((n_pix, 3), np.float64)
    drain_step = n_pix * 64
    last_drain = 0

    def drain():
        packet_kernels.check_overflow()
        host_acc[...] += st["acc"].cpu().numpy().astype(np.float64)
        st["acc"].zero_()

    if sc.geom.packet is None and not static.use_brute_force:
        trs.refuse_without_table(pool_sort=pool_sort)
    pool_sort = pool_sort and sc.geom.packet is not None
    cur_pool = pool
    while True:
        if pool_sort:
            st = _vol_pool_sort(st, sc.geom.packet)
        for _ in range(k_iters):
            st = _vol_wavefront_body(static, camera, sc, media, st, pool_sort)
        ni = st["next_item"]
        if ni >= total:
            # Queue drained (see gdpt_soa._gdpt_shrink_pool): keep live
            # lanes and dead-but-unharvested ones (their radiance is
            # harvested at the start of the next iteration).
            keep = st["lane"]["active"] | st["pending"]
            n_keep = int(keep.sum())
            if n_keep == 0:
                break
            if compact:
                tgt = ps._tail_bucket(n_keep, cur_pool, lane_q)
                if tgt is not None:
                    st = gs._gdpt_shrink_pool(st, tgt, keep)
                    cur_pool = tgt
        if ni - last_drain >= drain_step:
            drain()
            last_drain = ni
    drain()
    _vol_wavefront_accum.last_occupancy = float(st["occ_sum"]) / max(st["iters"], 1)
    _vol_wavefront_accum.last_iters = st["iters"]
    _vol_wavefront_accum.last_pool = cur_pool
    return host_acc.T, float(st["lane"]["rays"])


_vol_wavefront_accum.last_iters = 0
_vol_wavefront_accum.last_occupancy = 0.0
_vol_wavefront_accum.last_pool = 0


def _vol_pass(static, camera, sc, media, ray_idx, seed, sample0, n_samples):
    """n_samples samples summed in f32 for the whole ray batch; returns
    (radiance V3, total rays as an f32 0-d tensor)."""
    acc = V3(*(torch.zeros(ray_idx.shape[0], dtype=REAL, device=ray_idx.device),) * 3)
    rays = torch.zeros((), dtype=REAL, device=ray_idx.device)
    for i in range(n_samples):
        r, nr = trace_volpath_soa(static, camera, sc, media, ray_idx, seed, sample0 + i)
        acc = V3(acc.x + r.x, acc.y + r.y, acc.z + r.z)
        rays = rays + nr
    return acc, rays


def render_volpath_soa(scene: Scene, spp=None, seed=0, return_stats=False, wavefront=None,
                       pool=1 << 17, compact=True, pool_sort=False, packet_wide=32,
                       packet_dual=False, start_sample=0, init_acc=None, on_chunk=None,
                       mesh=None, **cast):
    """SoA volumetric render on the scene's device. Returns an (h, w, 3)
    float32 numpy image (and, with return_stats, the traced ray count);
    non-finite pixels become 0.

    wavefront (None, True or False), start_sample, init_acc, on_chunk
    and mesh choose the wavefront lane pool or the banded loop
    (banded.route). pool, compact and pool_sort are the wavefront's lane
    count, tail compaction and pool sort.
    packet_wide (16 or 32) is the width of a BVH scene's packet table;
    packet_dual=True walks a 16-wide table with the dual kernel K4 in
    place of K3 (with width 32 it raises ValueError); **cast (two_phase,
    packet_sort, premerge, entry_k, packet, max_table_mb): see
    path_soa.scene_soa_from_aos.

    The banded loop (banded.loop) resumes from start_sample and init_acc
    (the raw (3, n) float64 sample sums), calls on_chunk(acc, done) after
    every pass, and over a mesh (parallel/sharding.Mesh) pads each pass's
    rays to whole 128-lane groups per device (padded lanes trace pixel 0
    and count in the ray total, as the reference's do)."""
    static = scene.static
    w, h = static.width, static.height
    spp = spp if spp is not None else static.options.samples_per_pixel
    n = w * h
    wavefront = banded.route(wavefront, static, n, spp, start_sample, init_acc, on_chunk, mesh)
    seed = int(seed) & ps._M32

    def views(scene_d):
        return (ps.scene_soa_from_aos(scene_d, packet_wide, packet_dual, **cast),
                meds.media_soa(scene_d.device.media))

    def finish(acc, total_rays):
        img = banded.image(acc, spp, w, h)
        return (img, total_rays) if return_stats else img

    if wavefront:
        return finish(*_vol_wavefront_accum(static, scene.device.camera, *views(scene), spp,
                                            seed, n, pool=pool, compact=compact,
                                            pool_sort=pool_sort))

    def sample(v, xs, ys, ray_idx, done, k):
        return _vol_pass(static, *v, ray_idx, seed, done, k)

    return banded.loop(scene, spp, lambda s: (s.device.camera, *views(s)), sample, (3,),
                       1 << 24, start_sample, init_acc, on_chunk, mesh, finish)
