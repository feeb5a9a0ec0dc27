"""Batched (SoA) gradient-domain path tracing on tensors.

Counterpart of gdpt_tpu/integrators/gdpt_soa.py: base path + 4 offset
paths traced in lockstep sharing one counter-based random stream per
lane, diffuse-diffuse reconnection with the geometry-ratio Jacobian,
random-number-reuse replay with the pdf-ratio Jacobian,
one-sided-difference MIS weights, NEE+MIS primal alongside (reference:
small_gdpt.cpp:153-352, src/path_tracing.h:354-1050,
src/render.cpp:257-370), then the screened-Poisson reconstruction of
ops/poisson.py. Same RNG streams and use-site counters as the
reference, so at low spp the port is held against it buffer by buffer.

The 4 offsets are an unrolled Python loop, so every op stays an (N,)
component-tensor op. Cost per bounce is about 5x a plain path bounce
(1 base scatter + NEE shadow + 4x offset probe/replay rays); the 5
primaries ride one 5n-lane cast and the probe/replay rays one 8n-lane
cast.

Ported: the banded sample loop (brute-force scenes) and the wavefront
lane pool (BVH scenes) behind ``render_gradpath_soa``. Not yet, and
raising NotImplementedError when asked for: the pool-sorted wavefront,
sharding (``mesh=``) and checkpointed renders (``on_chunk``,
``init_acc``, ``start_sample``); see ROADMAP.md. The per-ray oracle
integrators/gdpt.py of the reference is not ported either.

Every tensor is made on the device the scene lives on.
"""

from typing import NamedTuple

import numpy as np
import torch

from gdpt_tpu_torch.accel import packet_kernels
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.ops import poisson
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene.build import Scene

GDPT_MAX_DEPTH = 32  # reference: small_gdpt.cpp:15

# Offset order: x-1, x+1, y-1, y+1 (image space, y down).
_OFFSETS = ((-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))

# sign -1: gradient stored as (base - offset); +1: (offset - base).
_SIGNS = (-1.0, 1.0, -1.0, 1.0)


class GdptSampleSoA(NamedTuple):
    primal: V3      # NEE+MIS estimate (the Poisson data term)
    primal_bf: V3   # BF emitter-hit estimate (noise-matched to gradients)
    gx_here: V3     # estimate of u[x] - u[x-1] stored at x
    gx_next: V3     # estimate of u[x+1] - u[x] stored at x
    gy_here: V3
    gy_next: V3


def supports_soa_gdpt(scene: Scene) -> bool:
    """Same material/texture envelope as the path fast path: what
    ops/materials_soa.py shades today (Lambertian materials with constant
    or checkerboard slots, no envmap)."""
    st = scene.static
    return (set(st.used_material_kinds) <= {M.MAT_LAMBERTIAN} and not st.has_envmap
            and not any(st.spec_image_slots) and 2 not in st.float_tex_slots)


def _is_lambertian(sc, static, material_id):
    if M.MAT_LAMBERTIAN not in static.used_material_kinds:
        return torch.zeros_like(material_id, dtype=torch.bool)
    mid = torch.clamp_min(material_id, 0)
    return (material_id >= 0) & (soa.take(sc.mat_tables.kind, mid) == M.MAT_LAMBERTIAN)


def _geom_term(p0: V3, n0: V3, p1: V3, n1: V3):
    """|cos0 cos1| / dist^2 (reference: small_gdpt.cpp:255-267)."""
    d = p1 - p0
    d2 = torch.clamp_min(soa.length_squared(d), 1e-20)
    dn = d * (1.0 / torch.sqrt(d2))
    return torch.abs(soa.dot(dn, n1)) * torch.abs(soa.dot(dn, n0)) / d2


def _cat3(vs):
    return V3(torch.cat([v.x for v in vs]), torch.cat([v.y for v in vs]),
              torch.cat([v.z for v in vs]))


def _cast(static, sc, org: V3, d: V3, tnear, tfar):
    """Closest hits of a batch whose retired lanes carry tfar = -1. The
    BVH walk exits those at once and reports a miss; the brute-force
    kernel K1 takes no tfar and casts them in full, so their hits are
    turned into misses here."""
    hit, gn = trs.intersect_soa_gn(static, sc.geom, org, d, tnear, tfar)
    if static.use_brute_force:
        hit = hit._replace(prim_id=torch.where(tfar >= 0, hit.prim_id, -1))
    return hit, gn


def _init_gdpt_lanes(static, camera, sc: ps.SceneSoA, pixel, sample, seed, live):
    """Fresh per-lane GDPT state for (pixel, sample) work items (int64
    tensors of uint32 values).

    live: bool mask — the other lanes get dead primary rays
    (tfar < tnear), so they cost nothing in the BVH walk and come back
    inactive. The 5 primaries (base + 4 offsets) ride ONE batched
    5n-lane cast + shade."""
    n = pixel.shape[0]
    dev = pixel.device
    zero = torch.zeros(n, dtype=REAL, device=dev)
    zero3 = V3(zero, zero, zero)
    one = torch.ones(n, dtype=REAL, device=dev)
    one3 = V3(one, one, one)
    xs = (pixel % static.width).to(REAL)
    ys = (pixel // static.width).to(REAL)
    u0, u1 = soa.uniform2(seed, pixel, ps._CTR_PIXEL, sample)
    orgs, ds = [], []
    for dx, dy in ((0.0, 0.0),) + _OFFSETS:
        o, d = ps.primary_rays_soa(static, camera, xs + dx, ys + dy, u0, u1)
        orgs.append(o)
        ds.append(d)
    borg, bdir = _cat3(orgs), _cat3(ds)
    tfar = torch.where(live, BIG, -1.0).repeat(5)
    bhit, bgn = _cast(static, sc, borg, bdir, 0.0, tfar)
    bv = ps.shade_hit(static, sc, borg, bdir, bhit, bgn)

    def part(i):
        sl = slice(i * n, (i + 1) * n)
        v = soa.tree_map(lambda a: a[sl], bv)
        return v, V3(bdir.x[sl], bdir.y[sl], bdir.z[sl]), bhit.prim_id[sl]

    base_v, base_d, base_prim = part(0)
    offs = []
    for i in range(4):
        ov, od, oprim = part(1 + i)
        # Offset validity: hit + same material as base primary hit
        # (reference: src/path_tracing.h:424-443).
        ovalid = (ov.valid > 0) & (ov.material_id == base_v.material_id)
        offs.append(dict(
            valid=ovalid.to(REAL), merged=zero, v=ov, d=od, prim=oprim,
            contrib=one3, prob=one, jacob=one,
        ))
    base_ok = base_v.valid > 0
    radiance0 = soa.where(base_ok, ps.emission(sc, base_v, -1.0 * base_d), zero3)
    return dict(
        radiance=radiance0,
        primal_bf=zero3,
        diffs=(zero3, zero3, zero3, zero3),
        base_v=base_v,
        base_d=base_d,
        base_prim=base_prim,
        contrib=one3,
        prob=one,
        eta_scale=one,
        offs=tuple(offs),
        active=base_v.valid,
        bounce=torch.zeros(n, dtype=INT, device=dev),
        pixel=pixel,
        sample=sample,
    )


def _gdpt_bounce(static, sc: ps.SceneSoA, used, seed, s):
    """One shared GDPT bounce over per-lane state (lanes may sit at
    different depths: bounce/pixel/sample are per-lane, so both the
    banded sample loop and the wavefront pool run this same body).
    s carries the scalar ray counter in s["rays"]."""
    md = static.options.max_depth
    n_iters = GDPT_MAX_DEPTH if md < 0 else min(md, GDPT_MAX_DEPTH)
    n = s["prob"].shape[0]
    zero = torch.zeros(n, dtype=REAL, device=s["prob"].device)
    zero3 = V3(zero, zero, zero)
    eps_isect = static.intersection_epsilon

    def uni2(bounce, ctr):
        return soa.uniform2(seed, s["pixel"], bounce * ps._CTR_STRIDE + ctr, s["sample"])

    base_v = s["base_v"]
    b = s["bounce"] + 1
    active = s["active"] > 0

    # --- light hit: accumulate this path-prefix's BF radiance and
    # one-sided differences, then KEEP TRACING (the reference's base
    # path bounces off emitters too, src/path_tracing.h:968-1010). Each
    # prefix uses its own prob/jacobian/MIS weight. ---
    base_is_light = base_v.light_id >= 0
    hit_light = active & base_is_light & (s["prob"] > 0)
    emitted = ps.emission(sc, base_v, -1.0 * s["base_d"])
    prob_c = torch.clamp_min(s["prob"], 1e-30)
    base_term = s["contrib"] * emitted
    primal_bf = s["primal_bf"] + soa.where(hit_light, base_term * (1.0 / prob_c), zero3)
    new_diffs = []
    for i, off in enumerate(s["offs"]):
        ov = off["v"]
        merged = off["merged"] > 0
        o_emit = ps.emission(sc, ov, -1.0 * off["d"])
        o_is_light = ov.light_id >= 0
        term_valid = (off["valid"] > 0) & (merged | o_is_light)
        term_c = soa.where(
            term_valid,
            soa.where(merged, off["contrib"] * emitted,
                      off["contrib"] * o_emit) * off["jacob"],
            zero3,
        )
        p_shift = off["prob"] * off["jacob"]
        w = torch.where(
            term_valid,
            s["prob"] / torch.clamp_min(s["prob"] + p_shift, 1e-30),
            1.0,
        )
        d_i = (term_c - base_term) * (_SIGNS[i] * w / prob_c)
        new_diffs.append(s["diffs"][i] + soa.where(hit_light, d_i, zero3))

    contrib = s["contrib"]
    new_offs = []

    # --- extension (continues through emitters) ---
    extend = active
    dir_view = -1.0 * s["base_d"]
    params = msoa.gather_params_soa(
        sc.mat_tables, used, base_v.material_id, base_v.uv_u, base_v.uv_v,
        static.spec_image_slots, float_tex_slots=static.float_tex_slots,
    )
    throughput = s["contrib"] * (1.0 / torch.clamp_min(s["prob"], 1e-30))

    # Primal NEE alongside (reference: src/path_tracing.h:115-227).
    radiance = s["radiance"]
    rays = s["rays"]
    if static.n_lights > 0:
        lu0, lu1 = uni2(b, ps._CTR_LIGHT_UV)
        lw, lsw = uni2(b, ps._CTR_LIGHT_W)
        nee, shadow_mask = ps.nee_soa(static, sc, base_v, params, dir_view,
                                      used, lu0, lu1, lw, lsw, extend)
        radiance = radiance + throughput * nee
        rays = rays + shadow_mask.sum()

    bu0, bu1 = uni2(b, ps._CTR_BSDF_UV)
    w_lobe, u_rr = uni2(b, ps._CTR_BSDF_W)
    samp = msoa.sample_bsdf_soa(params, dir_view, base_v.gn, base_v.frame,
                                bu0, bu1, w_lobe, used)
    f_base = msoa.eval_bsdf_soa(params, dir_view, samp.dir_out,
                                base_v.gn, base_v.frame, used)
    pdf_base = msoa.pdf_bsdf_soa(params, dir_view, samp.dir_out,
                                 base_v.gn, base_v.frame, used)
    is_transmit = (samp.valid > 0) & (samp.eta != 0)
    eta_scale = torch.where(
        is_transmit,
        s["eta_scale"] / torch.where(is_transmit, samp.eta, 1.0) ** 2,
        s["eta_scale"],
    )

    # Russian roulette on the base path (reference:
    # src/path_tracing.h:992-999); survival prob folded into the
    # base prob AND every offset prob so contrib/prob stays an
    # unbiased pair (factor cancels in the shift MIS weights).
    num_vertices = s["bounce"] + 3
    do_rr = (num_vertices - 1) >= static.options.rr_depth
    rr_prob = torch.where(
        do_rr,
        torch.clamp_max(
            soa.vmax(s["contrib"]) / (prob_c * torch.clamp_min(eta_scale, 1e-20)),
            0.95,
        ),
        1.0,
    )
    survive = (~do_rr) | (u_rr <= rr_prob)
    # Inactive lanes become dead rays (tfar < tnear).
    nxt_hit, nxt_gn = _cast(static, sc, base_v.position, samp.dir_out, eps_isect,
                            torch.where(extend, BIG, -1.0))
    nxt = ps.shade_hit(static, sc, base_v.position, samp.dir_out, nxt_hit, nxt_gn)
    nxt_ok = nxt.valid > 0
    ok_base = (samp.valid > 0) & (pdf_base > 0) & nxt_ok
    base_diffuse = _is_lambertian(sc, static, base_v.material_id)
    rays = rays + extend.to(REAL).sum()

    # Primal MIS-weighted emitter hit
    # (reference: src/path_tracing.h:291-325).
    if static.n_lights > 0:
        dist2 = soa.length_squared(nxt.position - base_v.position)
        g2 = torch.abs(soa.dot(samp.dir_out, nxt.gn)) / torch.clamp_min(dist2, 1e-20)
        p2a = pdf_base * g2
        nxt_is_light = nxt_ok & (nxt.light_id >= 0)
        l_emit = ps.emission(sc, nxt, -1.0 * samp.dir_out)
        p1h = ps.hit_light_pdf_soa(static, sc, base_v.position, nxt, samp.dir_out, dist2)
        w2 = p2a * p2a / torch.clamp_min(p1h * p1h + p2a * p2a, 1e-30)
        c2 = f_base * l_emit * (g2 * w2 / torch.clamp_min(p2a, 1e-30))
        radiance = radiance + soa.where(
            extend & ok_base & nxt_is_light, throughput * c2, zero3)

    # Offsets, phase A: everything up to the casts, plus the probe
    # (reconnection) and replay rays for ALL four offsets. The casts then
    # go through ONE batched 8n-lane call.
    g_base = _geom_term(base_v.position, base_v.gn, nxt.position, nxt.gn)
    off_a = []
    for off in s["offs"]:
        ov = off["v"]
        ovalid = off["valid"] > 0
        merged = off["merged"] > 0

        o_params = msoa.gather_params_soa(
            sc.mat_tables, used, ov.material_id, ov.uv_u, ov.uv_v,
            static.spec_image_slots, float_tex_slots=static.float_tex_slots,
        )
        o_view = -1.0 * off["d"]
        o_diffuse = _is_lambertian(sc, static, ov.material_id)
        can_reconnect = base_diffuse & o_diffuse & nxt_ok

        # Reconnection direction (reference: small_gdpt.cpp:248-269).
        to_next = nxt.position - ov.position
        dist = torch.clamp_min(soa.length(to_next), 1e-20)
        dir_rec = to_next * (1.0 / dist)

        # Replay with the base's randoms (small_gdpt.cpp:272-279).
        o_samp = msoa.sample_bsdf_soa(o_params, o_view, ov.gn, ov.frame,
                                      bu0, bu1, w_lobe, used)
        off_a.append(dict(
            ovalid=ovalid, merged=merged, o_params=o_params, o_view=o_view,
            o_samp=o_samp, can_reconnect=can_reconnect, dir_rec=dir_rec,
            # MERGED offsets follow the base path exactly (their
            # contribution is oc * f_base and their next vertex is the
            # base's nxt) — neither the reconnection probe nor the
            # replay ray is consulted for them, so both ride as dead
            # rays. On all-diffuse scenes offsets merge at the first
            # bounce, which empties about all 8n offset lanes for the
            # rest of the path. The replay result is also unused when
            # the reconnection fires this bounce (do_rec), so it is
            # gated on ~can_reconnect too.
            probe_tfar=torch.where(
                extend & ovalid & can_reconnect & ~merged, BIG, -1.0),
            rep_tfar=torch.where(
                extend & ovalid & ~merged & ~can_reconnect, BIG, -1.0),
        ))

    borg = _cat3([off["v"].position for off in s["offs"]] * 2)
    bdir = _cat3([a["dir_rec"] for a in off_a] + [a["o_samp"].dir_out for a in off_a])
    btfar = torch.cat([a["probe_tfar"] for a in off_a] + [a["rep_tfar"] for a in off_a])
    bhit, bgn = _cast(static, sc, borg, bdir, eps_isect, btfar)

    def part(i):
        sl = slice(i * n, (i + 1) * n)
        return soa.tree_map(lambda a: a[sl], bhit), soa.tree_map(lambda a: a[sl], bgn)

    # Phase B: per-offset consumption of the sliced results.
    for i, (off, a) in enumerate(zip(s["offs"], off_a)):
        ov = off["v"]
        ovalid, merged = a["ovalid"], a["merged"]
        oc, op, oj = off["contrib"], off["prob"], off["jacob"]
        o_params, o_view, o_samp = a["o_params"], a["o_view"], a["o_samp"]
        can_reconnect, dir_rec = a["can_reconnect"], a["dir_rec"]

        # Merged: follow base factors (reference: src/path_tracing.h:774-778).
        mc = oc * f_base
        mp = op * pdf_base

        probe_hit, _ = part(i)
        probe_ok = (probe_hit.prim_id >= 0) & (
            probe_hit.prim_id == torch.clamp_min(nxt_hit.prim_id, 0)
        ) & nxt_ok
        f_rec = msoa.eval_bsdf_soa(o_params, o_view, dir_rec, ov.gn, ov.frame, used)
        pdf_rec = msoa.pdf_bsdf_soa(o_params, o_view, dir_rec, ov.gn, ov.frame, used)
        g_shift = _geom_term(ov.position, ov.gn, nxt.position, nxt.gn)
        rec_valid = probe_ok & (pdf_rec > 0)
        rec_c = oc * f_rec
        rec_p = op * pdf_rec
        rec_j = oj * g_shift / torch.clamp_min(g_base, 1e-20)

        f_rep = msoa.eval_bsdf_soa(o_params, o_view, o_samp.dir_out, ov.gn, ov.frame, used)
        pdf_rep = msoa.pdf_bsdf_soa(o_params, o_view, o_samp.dir_out, ov.gn, ov.frame, used)
        o_nxt_hit, o_nxt_gn = part(4 + i)
        o_nxt = ps.shade_hit(static, sc, ov.position, o_samp.dir_out, o_nxt_hit, o_nxt_gn)
        rep_valid = (
            (o_samp.valid > 0) & (pdf_rep > 0) & (o_nxt.valid > 0)
            & (o_nxt.material_id == nxt.material_id)
        )
        rep_c = oc * f_rep
        rep_p = op * pdf_rep
        rep_j = oj * pdf_base / torch.clamp_min(pdf_rep, 1e-20)

        do_rec = can_reconnect & ~merged
        new_merged = merged | do_rec
        new_valid = ovalid & (merged | torch.where(do_rec, rec_valid, rep_valid))
        new_c = soa.where(merged, mc, soa.where(do_rec, rec_c, rep_c))
        # Offsets share the base's RR decision and survival prob.
        new_p = torch.where(merged, mp, torch.where(do_rec, rec_p, rep_p)) * rr_prob
        new_j = torch.where(merged, oj, torch.where(do_rec, rec_j, rep_j))
        new_v = soa.tree_where(new_merged, nxt, o_nxt)
        new_prim = torch.where(new_merged, nxt_hit.prim_id, o_nxt_hit.prim_id)
        new_d = soa.where(new_merged, samp.dir_out, o_samp.dir_out)

        upd = extend & ovalid
        new_offs.append(dict(
            valid=torch.where(upd, new_valid, ovalid).to(REAL),
            merged=torch.where(upd, new_merged, merged).to(REAL),
            v=soa.tree_where(upd, new_v, ov),
            d=soa.where(upd, new_d, off["d"]),
            prim=torch.where(upd, new_prim, off["prim"]),
            contrib=soa.where(upd, new_c, oc),
            prob=torch.where(upd, new_p, op),
            jacob=torch.where(upd, new_j, oj),
        ))
        rays = rays + 2.0 * upd.to(REAL).sum()

    ext_ok = extend & ok_base & survive
    new_contrib = soa.where(ext_ok, contrib * f_base, contrib)
    new_prob = torch.where(ext_ok, s["prob"] * pdf_base * rr_prob, s["prob"])
    new_base_v = soa.tree_where(ext_ok, nxt, base_v)

    # Per-lane depth cap (lanes in a wavefront pool sit at different
    # depths).
    ext_ok = ext_ok & (s["bounce"] + 1 <= n_iters)
    return dict(
        radiance=radiance,
        primal_bf=primal_bf,
        diffs=tuple(new_diffs),
        base_v=new_base_v,
        base_d=soa.where(ext_ok, samp.dir_out, s["base_d"]),
        base_prim=torch.where(ext_ok, nxt_hit.prim_id, s["base_prim"]),
        contrib=new_contrib,
        prob=new_prob,
        eta_scale=torch.where(ext_ok, eta_scale, s["eta_scale"]),
        offs=tuple(new_offs),
        active=ext_ok.to(REAL),
        bounce=s["bounce"] + 1,
        pixel=s["pixel"],
        sample=s["sample"],
        rays=rays,
    )


def trace_gdpt_soa(static, camera, sc: ps.SceneSoA, xs, ys, ray_idx, seed, sample0):
    """One GDPT sample for every lane (the banded loop's entry): init the
    5-path lockstep state, run the shared bounce to extinction. Returns
    (GdptSampleSoA, rays as an f32 0-d tensor). seed and sample0 are
    Python ints (uint32 values)."""
    used = static.used_material_kinds
    n = ray_idx.shape[0]
    del xs, ys  # pixel coords derive from ray_idx (the pixel index)
    dev = ray_idx.device
    pixel = ray_idx.to(torch.int64)
    sample = torch.full((n,), int(sample0) & ps._M32, dtype=torch.int64, device=dev)
    state = _init_gdpt_lanes(static, camera, sc, pixel, sample, seed,
                             torch.ones(n, dtype=torch.bool, device=dev))
    state["rays"] = torch.tensor(5.0 * n, dtype=REAL, device=dev)
    while bool((state["active"] > 0).any()):
        state = _gdpt_bounce(static, sc, used, seed, state)

    # Accumulated per-prefix terms (reference pairing:
    # src/path_tracing.h:1016-1049, small_gdpt.cpp:488-507 — but one
    # term per light hit instead of one product at loop end).
    return (GdptSampleSoA(state["radiance"], state["primal_bf"], *state["diffs"]),
            state["rays"])


def _gdpt_wavefront_body(static, camera, sc, used, st):
    """One wavefront iteration: harvest finished lanes into the per-pixel
    accumulator, refill them with the next (pixel, sample) work items
    (batched 5n-lane primary), then run the shared bounce.

    The banded loop pays full-width material/NEE/update cost for every
    drain iteration while live lanes decay under RR; the pool keeps
    about every lane on useful work (wavefront analog of path_soa's
    render_soa_wavefront; reference scheduling analog:
    src/render.cpp:82-117).

    The work queue's position is a Python int: the refill rule reads the
    dead-lane count on the host once per iteration (where the reference
    branches on the device with lax.cond), and from it the number of
    items handed out follows without a second read. st["acc"] is updated in
    place."""
    s = st["lane"]
    n_pix = static.width * static.height
    dead = s["active"] <= 0
    pending = st["pending"] > 0
    harvest = dead & pending

    vals = [s["radiance"], s["primal_bf"], *s["diffs"]]
    upd = torch.stack(
        [torch.where(harvest, c, 0.0) for v3 in vals for c in (v3.x, v3.y, v3.z)], dim=1)
    st["acc"].index_add_(0, s["pixel"], upd)

    pah = pending & ~harvest
    pool = s["prob"].shape[0]
    n_dead = int(dead.sum())
    next_item, total = st["next_item"], st["total"]
    # Refill only when a quarter of the pool is idle (or the queue has
    # drained): the refill's batched 5n-lane primary shade is a
    # full-width cost whether 1 lane or 100k lanes regenerate, so it
    # amortizes over >= pool/4 fresh paths per trigger.
    if n_dead * 4 >= pool and next_item < total:
        rank = torch.cumsum(dead.to(torch.int64), dim=0) - 1
        item = next_item + torch.where(dead, rank, 0)
        take = dead & (item < total)
        new_pixel = torch.where(take, item % n_pix, s["pixel"])
        new_sample = torch.where(take, item // n_pix, s["sample"])
        fresh = _init_gdpt_lanes(static, camera, sc, new_pixel, new_sample,
                                 st["seed"], take)
        n_take = min(n_dead, total - next_item)
        lane = soa.tree_where(take, fresh, {k: s[k] for k in fresh})
        lane["rays"] = s["rays"] + 5.0 * n_take
        pending2 = (take | pah).to(REAL)
        next_item = next_item + n_take
    else:
        lane, pending2 = dict(s), pah.to(REAL)
    # Occupancy telemetry: live fraction ENTERING the bounce (post-
    # refill), i.e. how much of the full-width bounce cost is useful
    # work.
    occ = (lane["active"] > 0).to(REAL).mean()
    lane = _gdpt_bounce(static, sc, used, st["seed"], lane)
    return dict(st, lane=lane, pending=pending2, next_item=next_item,
                occ_sum=st["occ_sum"] + occ, iters=st["iters"] + 1)


def _gdpt_shrink_pool(st, new_pool, keep):
    """Tail compaction for the 5-path pool (see path_soa._shrink_pool_state):
    once the work queue drains, compact surviving lanes into the
    smallest pow-2 quantum-aligned pool so every remaining dispatch pays
    sort/cast/material cost proportional to real work. keep: device bool
    mask of lanes to retain (live or dead-with-pending-harvest)."""
    order = ps._compact_take_order(keep, new_pool)

    def shrink(a):
        return a[order]

    lane = {k: (v if k == "rays" else soa.tree_map(shrink, v))
            for k, v in st["lane"].items()}
    return dict(st, lane=lane, pending=shrink(st["pending"]))


def _gdpt_wavefront_state(static, camera, sc, total, seed, pool):
    """The wavefront's state before its first iteration: an all-dead lane
    pool of `pool` lanes, the work queue at item 0 of `total`, a zeroed
    (n_pix, 18) accumulator (six buffers x rgb)."""
    device = camera.sample_to_cam.device
    n_pix = static.width * static.height
    seed = int(seed) & ps._M32
    zeros_u = torch.zeros(pool, dtype=torch.int64, device=device)
    lane0 = _init_gdpt_lanes(static, camera, sc, zeros_u, zeros_u, seed,
                             torch.zeros(pool, dtype=torch.bool, device=device))
    lane0["rays"] = torch.tensor(0.0, dtype=REAL, device=device)
    return dict(
        lane=lane0,
        acc=torch.zeros((n_pix, 18), dtype=REAL, device=device),
        pending=torch.zeros(pool, dtype=REAL, device=device),
        next_item=0,
        total=total,
        seed=seed,
        occ_sum=torch.tensor(0.0, dtype=REAL, device=device),
        iters=0,
    )


def _gdpt_wavefront_accum(static, camera, sc, spp, seed, n_pix, k_iters=6,
                          pool=1 << 17, compact=True):
    """Run the GDPT wavefront to completion; returns (acc (6,3,n) f64
    sample sums, total_rays). pool: lane-pool width asked for (cut to the
    work, in whole dispatch quanta); compact: tail compaction. The
    iteration count and mean occupancy of the last run are left in
    _gdpt_wavefront_accum.last_iters and .last_occupancy."""
    total = n_pix * spp
    if total >= 2 ** 32:
        # (pixel, sample) items are uint32 values in the RNG streams
        # (render_gradpath_soa routes such renders to the banded loop).
        raise ValueError(
            f"GDPT wavefront work queue: n_pix*spp = {total} >= 2^32; "
            "use the banded loop for renders this large")
    lane_q = ps.LANE_QUANTUM
    pool = ps._pool_width(total, pool)
    st = _gdpt_wavefront_state(static, camera, sc, total, seed, pool)
    used = static.used_material_kinds
    # Drain the f32 device accumulator into host f64 every ~64 started
    # spp-equivalents (see path_soa.render_soa_wavefront).
    host_acc = np.zeros((n_pix, 18), np.float64)
    drain_step = n_pix * 64
    last_drain = 0

    def drain():
        packet_kernels.check_overflow()
        host_acc[...] += st["acc"].cpu().numpy().astype(np.float64)
        st["acc"].zero_()

    cur_pool = pool
    while True:
        for _ in range(k_iters):
            st = _gdpt_wavefront_body(static, camera, sc, used, st)
        ni = st["next_item"]
        if ni >= total:
            # Queue drained: count lanes still carrying work (live, or
            # dead-but-unharvested — pending radiance is harvested at
            # the START of the next iteration, so it must survive
            # compaction).
            keep = (st["lane"]["active"] > 0) | (st["pending"] > 0)
            n_keep = int(keep.sum())
            if n_keep == 0:
                break
            if compact:
                tgt = ps._tail_bucket(n_keep, cur_pool, lane_q)
                if tgt is not None:
                    st = _gdpt_shrink_pool(st, tgt, keep)
                    cur_pool = tgt
        if ni - last_drain >= drain_step:
            drain()
            last_drain = ni
    drain()
    acc = host_acc.T.reshape(6, 3, n_pix)
    _gdpt_wavefront_accum.last_occupancy = float(st["occ_sum"]) / max(st["iters"], 1)
    _gdpt_wavefront_accum.last_iters = st["iters"]
    return acc, float(st["lane"]["rays"])


_gdpt_wavefront_accum.last_iters = 0
_gdpt_wavefront_accum.last_occupancy = 0.0


def _gdpt_pass(static, camera, sc, xs, ys, ray_idx, seed, sample0, n_samples):
    """n_samples GDPT samples summed in f32 for the whole ray batch;
    returns (GdptSampleSoA of sums, total rays as an f32 0-d tensor)."""
    acc, rays = None, torch.zeros((), dtype=REAL, device=xs.device)
    for i in range(n_samples):
        out, nr = trace_gdpt_soa(static, camera, sc, xs, ys, ray_idx, seed, sample0 + i)
        acc = out if acc is None else soa.tree_map(lambda a, o: a + o, acc, out)
        rays = rays + nr
    return acc, rays


def render_gradpath_soa(scene: Scene, spp=None, seed=0, return_aux=False,
                        return_stats=False, wavefront=None, pool=1 << 17, compact=True,
                        packet_wide=32, packet_dual=False, start_sample=0,
                        init_acc=None, on_chunk=None, mesh=None):
    """SoA GDPT render on the scene's device: accumulate primal + 4
    gradient buffers, then screened-Poisson reconstruct (reference:
    src/render.cpp:257-370). Returns the (h, w, 3) float32 numpy
    reconstruction; with return_aux also a dict of the primal, primal_bf,
    gx and gy images, with return_stats the traced ray count.

    wavefront=None takes the wavefront lane pool for BVH scenes whose work
    queue fits (n_pix * spp < 2^32) and the banded sample loop otherwise;
    True or False picks one. pool and compact are the wavefront's lane
    count and tail compaction. packet_wide (16 or 32) is the width of a
    BVH scene's packet table; packet_dual=True walks a 16-wide table with
    the dual kernel K4 in place of K3 (with width 32 it raises
    ValueError)."""
    for name, given in (("mesh (sharding)", mesh is not None),
                        ("on_chunk / init_acc / start_sample (checkpointed renders)",
                         on_chunk is not None or init_acc is not None or bool(start_sample))):
        if given:
            raise NotImplementedError(f"{name} is not ported yet; see ROADMAP.md")
    static = scene.static
    w, h = static.width, static.height
    spp = spp if spp is not None else static.options.samples_per_pixel
    n = w * h
    sc = ps.scene_soa_from_aos(scene, packet_wide, packet_dual)
    camera = scene.device.camera
    device = camera.sample_to_cam.device

    if wavefront is None:
        # BVH scenes: the wavefront pool keeps the 5-path lockstep at
        # about full occupancy via sample regeneration instead of paying
        # full-width drain iterations per band-sample.
        wavefront = not static.use_brute_force and n * spp < 2 ** 32
    if wavefront:
        acc, total_rays = _gdpt_wavefront_accum(static, camera, sc, spp, seed, n,
                                                pool=pool, compact=compact)
        return _gdpt_finish(static, acc, spp, w, h, total_rays, return_aux,
                            return_stats, device)
    ys, xs = np.mgrid[0:h, 0:w]
    xs_d = torch.as_tensor(xs.ravel(), dtype=REAL, device=device)
    ys_d = torch.as_tensor(ys.ravel(), dtype=REAL, device=device)
    ray_idx = torch.arange(n, dtype=torch.int64, device=device)

    # About 5x the rays of a plain path sample per GDPT sample; BVH
    # scenes take one sample per pass, as the reference does.
    batch = max(1, (1 << 23) // n) if static.use_brute_force else 1
    # The 5-path state is large: big BVH images go through in equal
    # bands of pixels, as in the reference.
    pix_cap = 1 << 17
    if static.use_brute_force or n <= pix_cap:
        bands = [(0, n)]
    else:
        nb = -(-n // pix_cap)
        band = -(-n // nb)
        bands = [(lo, min(n, lo + band)) for lo in range(0, n, band)]

    acc = np.zeros((6, 3, n), np.float64)
    total_rays = 0.0
    done = 0
    while done < spp:
        k = min(batch, spp - done)
        for lo, hi in bands:
            out, nrays = _gdpt_pass(static, camera, sc, xs_d[lo:hi], ys_d[lo:hi],
                                    ray_idx[lo:hi], int(seed) & ps._M32, done, k)
            packet_kernels.check_overflow()
            for i, buf in enumerate(out):
                for c in range(3):
                    acc[i, c, lo:hi] += buf[c].cpu().numpy().astype(np.float64)
            total_rays += float(nrays)
        done += k
    return _gdpt_finish(static, acc, spp, w, h, total_rays, return_aux, return_stats, device)


def _gdpt_finish(static, acc, spp, w, h, total_rays, return_aux, return_stats, device):
    """Shared tail: (6,3,n) sample sums -> Poisson reconstruction, solved
    on `device`."""
    def img(i):
        return (acc[i] / spp).T.reshape(h, w, 3).astype(np.float32)

    primal, primal_bf, gxh, gxn, gyh, gyn = (img(i) for i in range(6))
    gx, gy = poisson.assemble_gradients(
        *(torch.as_tensor(a, device=device) for a in (gxh, gxn, gyh, gyn)))
    recon = poisson.screened_poisson_solve(
        torch.as_tensor(primal, device=device), gx, gy, static.options.gdpt_alpha
    ).cpu().numpy()
    recon = np.where(np.isfinite(recon), recon, 0.0).astype(np.float32)
    aux = dict(primal=primal, primal_bf=primal_bf,
               gx=gx.cpu().numpy(), gy=gy.cpu().numpy())
    if return_aux and return_stats:
        return recon, aux, total_rays
    if return_aux:
        return recon, aux
    if return_stats:
        return recon, total_rays
    return recon
