"""Gradient-domain path tracing (GDPT), the per-ray oracle of the SoA
`gradpath` renders, lane-batched, and its own driver render_gradpath.

Counterpart of gdpt_tpu/integrators/gdpt.py (reference: small_gdpt.cpp
:153-352, src/path_tracing.h:354-1050, src/render.cpp:257-370): for every
sample a base path at pixel (x, y) and four shift-mapped offset paths at
(x-1, y), (x+1, y), (x, y-1), (x, y+1), traced in lockstep on the same
random numbers (core/rng.py reproduces jax.random bit for bit). See the
reference module's docstring for the estimator: offsets invalidated on a
primary miss or a material mismatch, reconnection at diffuse-diffuse
vertices with a geometry-term Jacobian, replay of the base's BSDF random
numbers otherwise, one path-prefix term per light hit, the NEE + MIS
primal beside the brute-force primal, Russian roulette folded into the
base's and every offset's prob.

Lane layout: the reference's vmap axis is the leading dimension (N base
lanes); its inner vmap over the four offsets is flattened offset-major
into 4N lanes (lane o * N + i is offset o of base lane i), and every base
value an offset reads is repeated to match (_rep). Offset pixels outside
the image (x - 1 = -1) are traced as the reference traces them. The
bounce while_loop is volpath._masked_loop (a host read a body, counted in
volpath.HOST_READS["gdpt"]); it runs n_iters + 1 bodies (bounce <=
n_iters), with RNG stream b = bounce + 1 as in integrators/path.py.

Casts go through ops/intersect.py to the port's kernels (K1/K2, or K3/K4
on a BVH scene's packet table) for the live lanes only. The reference
casts an offset's reconnection probe and its replay ray for every
offset; the port casts the probe only for the lanes that reconnect
(upd & do_rec) and the replay ray only for the lanes that replay
(upd & ~do_rec & ~merged), the only lanes whose state reads them, so the
state is the reference's and fewer rays are cast.
"""

from typing import NamedTuple

import numpy as np
import torch

from gdpt_tpu_torch.core import math as gm
from gdpt_tpu_torch.core import rng
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL, resolve_device
from gdpt_tpu_torch.core.math import lift as L
from gdpt_tpu_torch.core.math import where as W
from gdpt_tpu_torch.integrators import volpath
from gdpt_tpu_torch.integrators.path import nee_contribution
from gdpt_tpu_torch.ops import intersect as isect
from gdpt_tpu_torch.ops import lights as lgt
from gdpt_tpu_torch.ops import materials as mat
from gdpt_tpu_torch.scene import camera as gcam
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene.build import Scene, scene_to

GDPT_MAX_DEPTH = 32  # reference: small_gdpt.cpp:15, intersection.h MAX_DEPTH

# Offset order: x-1, x+1, y-1, y+1 (image space, y down).
_OFFSETS = np.array([[-1, 0], [1, 0], [0, -1], [0, 1]], np.float32)
# sign -1: gradient stored as (base - offset); +1: (offset - base).
_SIGNS = (-1.0, 1.0, -1.0, 1.0)
# Base lanes per pass of render_gradpath (the reference's): ~5x the rays
# of a plain path sample per GDPT sample.
LANES_PER_PASS = 1 << 18


class GdptSample(NamedTuple):
    """Per-sample output, each (N, 3): primal estimate and the 4 weighted
    one-sided differences (the reference's GraidentPTRadiance after driver
    math, reference: src/intersection.h:65-77, src/render.cpp:311-318)."""

    primal: torch.Tensor     # NEE+MIS estimate (the data term)
    primal_bf: torch.Tensor  # BF emitter-hit estimate (noise-matched to the gradients)
    gx_here: torch.Tensor    # estimate of u[x] - u[x-1] stored at x
    gx_next: torch.Tensor    # estimate of u[x+1] - u[x] stored at x
    gy_here: torch.Tensor
    gy_next: torch.Tensor


def _rep(v):
    """A base value (N, ...) or a NamedTuple of them, repeated for the 4N
    offset lanes (offset-major)."""
    if isinstance(v, tuple):
        return type(v)(*(_rep(a) for a in v))
    return v.repeat((4,) + (1,) * (v.dim() - 1))


def _is_kind(scene, static, material_id, kind):
    if kind not in static.used_material_kinds:
        return torch.zeros_like(material_id, dtype=torch.bool)
    mid = torch.clamp_min(material_id, 0).long()
    return (material_id >= 0) & (scene.materials.kind[mid] == kind)


def _geom_term(p0, n0, p1, n1):
    """|cos0 cos1| / dist^2 between two surface points
    (reference: small_gdpt.cpp:255-267)."""
    d = p1 - p0
    d2 = torch.clamp_min(gm.length_squared(d), 1e-20)
    dn = d / L(torch.sqrt(d2))
    return torch.abs(gm.dot(dn, n1)) * torch.abs(gm.dot(dn, n0)) / d2


def trace_gdpt(scene, static, casts, x, y, key) -> GdptSample:
    w, h = static.width, static.height
    used = static.used_material_kinds
    md = static.options.max_depth
    n_iters = GDPT_MAX_DEPTH if md < 0 else min(md, GDPT_MAX_DEPTH)
    n = x.shape[0]
    dev = x.device
    eps_isect = static.intersection_epsilon

    u_px = rng.uniform(key, 0, rng.SLOT_PIXEL, (2,))

    def primary(px, py, u):
        screen = torch.stack([(px + u[:, 0]) / w, (py + u[:, 1]) / h], dim=-1)
        org, d = gcam.sample_primary(
            scene.camera, w, h, static.filter_kind, static.filter_param, screen)
        return isect.intersect(scene, static, casts, org, d, 0.0, BIG), d

    base_v, base_d = primary(x, y, u_px)
    off_v, off_d = primary(torch.cat([x + float(o[0]) for o in _OFFSETS]),
                           torch.cat([y + float(o[1]) for o in _OFFSETS]), _rep(u_px))

    # Offset validity: hit + same material as base primary hit
    # (reference: src/path_tracing.h:424-443).
    off_valid = off_v.valid & (off_v.material_id == _rep(base_v.material_id))

    # NEE+MIS primal radiance runs alongside the gradient estimator.
    radiance0 = W(base_v.valid, lgt.emission_at_vertex(scene, static, base_v, -base_d), 0.0)

    z3 = torch.zeros(n, 3, dtype=REAL, device=dev)
    one = torch.ones(n, dtype=REAL, device=dev)
    state = dict(
        radiance=radiance0,
        primal_bf=z3,
        diffs=_rep(z3),
        base_v=base_v,
        base_d=base_d,
        contrib=z3 + 1.0,
        prob=one,
        eta_scale=one,
        off_v=off_v,
        off_d=off_d,
        off_valid=off_valid,
        merged=torch.zeros(4 * n, dtype=torch.bool, device=dev),
        off_contrib=_rep(z3) + 1.0,
        off_prob=_rep(one),
        jacob=_rep(one),
        active=base_v.valid,
        bounce=torch.zeros(n, dtype=INT, device=dev),
    )
    signs = torch.tensor(_SIGNS, dtype=REAL, device=dev).repeat_interleave(n)

    def cond(s):
        return s["active"] & (s["bounce"] <= n_iters)

    def body(s, live):
        base_v = s["base_v"]
        b = s["bounce"] + 1
        live4 = _rep(live)

        # --- light hit: accumulate this path-prefix's BF radiance and
        # one-sided differences, then keep tracing (the reference's
        # module docstring says why). ---
        base_is_light = scene.shape_light_id[base_v.shape_id.long()] >= 0
        hit_light = s["active"] & base_is_light & (s["prob"] > 0)
        emitted = lgt.emission_at_vertex(scene, static, base_v, -s["base_d"])
        prob_c = torch.clamp_min(s["prob"], 1e-30)
        base_term = s["contrib"] * emitted
        primal_bf = s["primal_bf"] + W(hit_light, base_term / L(prob_c), 0.0)

        # Each offset's term of this prefix: merged offsets share the
        # base's vertex; replaying offsets must sit on an emitter
        # themselves (reference: small_gdpt.cpp:282-284).
        ov, od, merged = s["off_v"], s["off_d"], s["merged"]
        oc, op, oj = s["off_contrib"], s["off_prob"], s["jacob"]
        o_emit = lgt.emission_at_vertex(scene, static, ov, -od)
        o_is_light = scene.shape_light_id[ov.shape_id.long()] >= 0
        term_valid = s["off_valid"] & (merged | o_is_light)
        term_c = W(term_valid, W(merged, oc * _rep(emitted), oc * o_emit) * L(oj), 0.0)
        prob4 = _rep(s["prob"])
        w_off = torch.where(term_valid, prob4 / torch.clamp_min(prob4 + op * oj, 1e-30), 1.0)
        d_all = (term_c - _rep(base_term)) * L(signs) * L(w_off / _rep(prob_c))
        diffs = s["diffs"] + W(_rep(hit_light), d_all, 0.0)

        contrib = s["contrib"]

        # --- extension (continues through emitters) ---
        extend = s["active"]
        dir_view = -s["base_d"]
        params = mat.gather_params(scene, static, base_v)
        throughput = contrib / L(prob_c)

        # Primal NEE (reference path-tracing NEE: src/path_tracing.h:115-227).
        radiance = s["radiance"]
        if static.n_lights > 0:
            nee = nee_contribution(scene, static, casts, key, b, base_v, params, dir_view,
                                   used, live)
            radiance = radiance + W(extend, throughput * nee, 0.0)

        uv_b = rng.uniform(key, b, rng.SLOT_BSDF_UV, (2,))
        w_b = rng.uniform(key, b, rng.SLOT_BSDF_W)
        samp = mat.sample_bsdf(params, dir_view, base_v, uv_b, w_b, used)
        f_base = mat.eval_bsdf(params, dir_view, samp.dir_out, base_v, used)
        pdf_base = mat.pdf_bsdf(params, dir_view, samp.dir_out, base_v, used)
        is_transmit = samp.valid & (samp.eta != 0)
        eta_t = torch.where(is_transmit, samp.eta, 1.0)
        eta_scale = torch.where(is_transmit, s["eta_scale"] / eta_t ** 2, s["eta_scale"])

        # Russian roulette on the base path, folded into prob and every
        # offset prob (reference: src/path_tracing.h:992-999).
        num_vertices = s["bounce"] + 3
        do_rr = (num_vertices - 1) >= static.options.rr_depth
        rr_prob = torch.where(
            do_rr,
            torch.clamp_max(contrib.amax(dim=-1)
                            / (prob_c * torch.clamp_min(eta_scale, 1e-20)), 0.95),
            1.0,
        )
        u_rr = rng.uniform(key, b, rng.SLOT_RR)
        survive = (~do_rr) | (u_rr <= rr_prob)
        nxt = isect.intersect(scene, static, casts, base_v.position, samp.dir_out, eps_isect,
                              BIG, live)
        ok_base = samp.valid & (pdf_base > 0) & nxt.valid
        base_diffuse = _is_kind(scene, static, base_v.material_id, M.MAT_LAMBERTIAN)

        # Primal MIS-weighted emitter hit (reference: src/path_tracing.h:291-325).
        if static.n_lights > 0:
            dist2 = gm.distance_squared(nxt.position, base_v.position)
            g2 = torch.abs(gm.dot(samp.dir_out, nxt.geom_normal)) / torch.clamp_min(dist2, 1e-20)
            p2a = pdf_base * g2
            hit_light_id = scene.shape_light_id[nxt.shape_id.long()]
            nxt_is_light = nxt.valid & (hit_light_id >= 0)
            lid = torch.clamp_min(hit_light_id, 0)
            l_emit = lgt.emission_at_vertex(scene, static, nxt, -samp.dir_out)
            p1h = lgt.light_pmf(scene, lid) * lgt.pdf_point_on_light(
                scene, static, lid, nxt.position, nxt.geom_normal, base_v.position)
            w2 = p2a * p2a / torch.clamp_min(p1h * p1h + p2a * p2a, 1e-30)
            c2 = L(g2) * f_base * l_emit / L(torch.clamp_min(p2a, 1e-30))
            radiance = radiance + W(extend & ok_base & nxt_is_light, throughput * c2 * L(w2),
                                    0.0)

        # --- the offsets' step, on 4N lanes ---
        nxt4 = _rep(nxt)
        pdf_base4 = _rep(pdf_base)
        ov_valid = s["off_valid"]
        # Merged: follow the base factors (reference: src/path_tracing.h:774-778).
        mc = oc * _rep(f_base)
        mp = op * pdf_base4

        o_params = mat.gather_params(scene, static, ov)
        o_view = -od
        o_diffuse = _is_kind(scene, static, ov.material_id, M.MAT_LAMBERTIAN)
        can_reconnect = _rep(base_diffuse) & o_diffuse & nxt4.valid
        do_rec = can_reconnect & ~merged
        upd = _rep(extend) & ov_valid

        # Reconnection to the base's next vertex (reference:
        # small_gdpt.cpp:248-269); the probe is cast for reconnecting lanes.
        to_next = nxt4.position - ov.position
        dist = torch.clamp_min(gm.length(to_next), 1e-20)
        dir_rec = to_next / L(dist)
        probe = isect.cast(static, casts, ov.position, dir_rec, eps_isect, BIG,
                           live4 & upd & do_rec)
        probe_ok = (probe.prim_id >= 0) & (probe.prim_id == nxt4.prim_id)
        f_rec = mat.eval_bsdf(o_params, o_view, dir_rec, ov, used)
        pdf_rec = mat.pdf_bsdf(o_params, o_view, dir_rec, ov, used)
        g_base = _geom_term(base_v.position, base_v.geom_normal, nxt.position, nxt.geom_normal)
        g_shift = _geom_term(ov.position, ov.geom_normal, nxt4.position, nxt4.geom_normal)
        rec_valid = probe_ok & (pdf_rec > 0)
        rec_c = oc * f_rec
        rec_p = op * pdf_rec
        rec_j = oj * g_shift / torch.clamp_min(_rep(g_base), 1e-20)

        # Replay with the base's random numbers (reference:
        # small_gdpt.cpp:272-279); the ray is cast for replaying lanes.
        o_samp = mat.sample_bsdf(o_params, o_view, ov, _rep(uv_b), _rep(w_b), used)
        f_rep = mat.eval_bsdf(o_params, o_view, o_samp.dir_out, ov, used)
        pdf_rep = mat.pdf_bsdf(o_params, o_view, o_samp.dir_out, ov, used)
        o_nxt = isect.intersect(scene, static, casts, ov.position, o_samp.dir_out, eps_isect,
                                BIG, live4 & upd & ~do_rec & ~merged)
        rep_valid = (o_samp.valid & (pdf_rep > 0) & o_nxt.valid
                     & (o_nxt.material_id == nxt4.material_id))
        rep_c = oc * f_rep
        rep_p = op * pdf_rep
        rep_j = oj * pdf_base4 / torch.clamp_min(pdf_rep, 1e-20)

        new_merged = merged | do_rec
        new_valid = ov_valid & torch.where(merged, True, torch.where(do_rec, rec_valid,
                                                                     rep_valid))
        new_c = W(merged, mc, W(do_rec, rec_c, rep_c))
        # Offsets share the base's RR decision and survival prob.
        new_p = torch.where(merged, mp, torch.where(do_rec, rec_p, rep_p)) * _rep(rr_prob)
        new_j = torch.where(merged, oj, torch.where(do_rec, rec_j, rep_j))
        # Merged offsets ride the base vertex; replaying offsets move to
        # their own next hit.
        new_v = volpath._select(new_merged, nxt4, o_nxt)
        new_d = W(new_merged, _rep(samp.dir_out), o_samp.dir_out)

        upd_base = extend & ok_base & survive
        return dict(
            radiance=radiance,
            primal_bf=primal_bf,
            diffs=diffs,
            base_v=volpath._select(upd_base, nxt, base_v),
            base_d=W(upd_base, samp.dir_out, s["base_d"]),
            contrib=W(upd_base, contrib * f_base, contrib),
            prob=torch.where(upd_base, s["prob"] * pdf_base * rr_prob, s["prob"]),
            eta_scale=torch.where(upd_base, eta_scale, s["eta_scale"]),
            off_v=volpath._select(upd, new_v, ov),
            off_d=W(upd, new_d, od),
            off_valid=torch.where(upd, new_valid, ov_valid),
            merged=torch.where(upd, new_merged, merged),
            off_contrib=W(upd, new_c, oc),
            off_prob=torch.where(upd, new_p, op),
            jacob=torch.where(upd, new_j, oj),
            active=s["active"] & ok_base & survive,
            bounce=s["bounce"] + 1,
        )

    out = volpath._masked_loop(cond, body, state, "gdpt")

    # Accumulated per-prefix terms (reference pairing:
    # src/path_tracing.h:1016-1049, small_gdpt.cpp:488-507).
    gx_here, gx_next, gy_here, gy_next = out["diffs"].reshape(4, n, 3)
    return GdptSample(primal=out["radiance"], primal_bf=out["primal_bf"], gx_here=gx_here,
                      gx_next=gx_next, gy_here=gy_here, gy_next=gy_next)


def render_gradpath(scene: Scene, spp=None, seed=0, return_aux=False, start_sample=0,
                    init_acc=None, on_chunk=None, device=None, return_stats=False,
                    packet_wide=32, packet_dual=False, **cast):
    """GDPT render driver on `device` (CUDA unless "cpu" is given):
    accumulate primal + 4 gradient buffers, then screened-Poisson
    reconstruct (reference: src/render.cpp:257-370). Returns the (h, w, 3)
    float32 reconstruction (non-finite pixels 0), with return_aux also the
    dict of its primal, primal_bf, gx and gy images, with return_stats the
    live rays cast.

    A pass traces LANES_PER_PASS // n_pix samples of every pixel (each a base
    and four offset paths), each lane keyed by pix * spp + sample; within
    a pass the samples are summed in f32 in sample order, the passes in
    float64 on the host, as the reference's driver sums them.
    start_sample/init_acc resume an interrupted accumulation (init_acc is
    the raw (6, n_pix, 3) float64 sample-sum array); on_chunk(acc, done)
    fires after every pass. packet_wide, packet_dual and **cast
    (two_phase, packet_sort, premerge, entry_k, packet, max_table_mb)
    pick a BVH scene's table and walk (path_soa.scene_soa_from_aos)."""
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.integrators.gdpt_soa import _gdpt_finish

    device = resolve_device(device)
    scene = scene_to(scene, device)
    static = scene.static
    w, h = static.width, static.height
    spp = spp if spp is not None else static.options.samples_per_pixel
    n_pix = w * h
    casts = isect.Casts(path_soa.scene_soa_from_aos(scene, packet_wide, packet_dual, **cast).geom)
    pix = torch.arange(n_pix, dtype=torch.int64, device=device)
    xs = (pix % w).to(REAL)
    ys = (pix // w).to(REAL)

    batch = max(1, LANES_PER_PASS // n_pix)
    acc = (np.zeros((6, n_pix, 3), np.float64) if init_acc is None
           else np.asarray(init_acc, np.float64).copy())
    done = int(start_sample)
    while done < spp:
        k = min(batch, spp - done)
        sample = done + torch.arange(k, dtype=torch.int64, device=device)
        ray_idx = (pix[None, :] * spp + sample[:, None]).reshape(-1)
        key = rng.ray_key(rng.prng_key(seed, ray_idx.shape[0], device), ray_idx)
        out = trace_gdpt(scene.device, static, casts, xs.repeat(k), ys.repeat(k), key)
        for i, buf in enumerate(out):
            buf = buf.reshape(k, n_pix, 3)
            total = torch.zeros((n_pix, 3), dtype=REAL, device=device)
            for j in range(k):
                total = total + buf[j]
            acc[i] += total.cpu().numpy().astype(np.float64)
        del out
        done += k
        if on_chunk is not None:
            on_chunk(acc, done)
    return _gdpt_finish(static, acc.transpose(0, 2, 1), spp, w, h, float(casts.rays),
                        return_aux, return_stats, device)
