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

Ported: the banded sample loop (brute-force scenes, checkpointed
renders: ``on_chunk``, ``init_acc``, ``start_sample``, and sharded
renders: ``mesh=``) and the wavefront lane pool (BVH scenes), which can
keep its lanes morton-sorted (``pool_sort=True``), behind
``render_gradpath_soa``. Its per-ray oracle is integrators/gdpt.py
(trace_gdpt, render_gradpath).

Every tensor is made on the device the scene lives on.

The banded loop is integrators/banded.py's. Its pass (_gdpt_pass)
replays the sample as one captured CUDA graph where path_soa's does
(banded.graphed: CUDA lanes, brute-force casts, max_depth > 0), through
banded.sample_pass; each sample adds into the pass's 18 f32 rows of sums
and its ray count in place (_add_gdpt_sample), replayed or eager alike.
CPU lanes, max_depth <= 0, the BVH banded route and the wavefront pool
run eagerly.

Program spans (utils/profiling): gdpt.primary (each lane refill's five
primaries, _init_gdpt_lanes), gdpt.bounce (each shared bounce, banded and
wavefront alike; on the graphed route only while a key's sample is warmed
and captured, in its first pass), gdpt.solve (the gradients' assembly,
the Poisson solve and the image's copy to the host), and the banded
loop's render.scene, render.lanes, render.readback and render.image (the
host's float64 sums, transposes and finite filter), as it opens them for
every integrator. The counter group gdpt_soa.work counts, in host
integers, the pixel samples traced and the bounce iterations run, a
replay's among them; gdpt_soa.graphs counts the samples per pixel
replayed from a graph or run eagerly (the wavefront pool's among them),
and the graphs captured.
"""

from typing import NamedTuple

import numpy as np
import torch

from gdpt_tpu_torch.accel import packet_kernels
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import banded
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.ops import poisson
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene.build import Scene
from gdpt_tpu_torch.utils import profiling

GDPT_MAX_DEPTH = 32  # reference: small_gdpt.cpp:15
# The banded loop takes a BVH image of more pixels than this in equal
# bands (the reference's PIX_CAP).
PIX_CAP = 1 << 17

# Offset order: x-1, x+1, y-1, y+1 (image space, y down).
_OFFSETS = ((-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))

# sign -1: gradient stored as (base - offset); +1: (offset - base).
_SIGNS = (-1.0, 1.0, -1.0, 1.0)

# Pixel samples traced and shared bounces run, over the process.
WORK = profiling.counter_group("gdpt_soa.work", {"samples": 0, "bounces": 0})
# Samples of gradpath renders: replayed from a captured graph, or run
# eagerly (banded passes, banded.sample_pass, and the wavefront pool's
# samples per pixel); and the graphs captured.
GRAPHS = profiling.counter_group("gdpt_soa.graphs", {"captured": 0, "replayed": 0, "eager": 0})


class GdptSampleSoA(NamedTuple):
    primal: V3      # NEE+MIS estimate (the Poisson data term)
    primal_bf: V3   # BF emitter-hit estimate (noise-matched to gradients)
    gx_here: V3     # estimate of u[x] - u[x-1] stored at x
    gx_next: V3     # estimate of u[x+1] - u[x] stored at x
    gy_here: V3
    gy_next: V3


def supports_soa_gdpt(scene: Scene) -> bool:
    """Same material/texture envelope as the path fast path, which is
    all of it (reference: gdpt_tpu/integrators/gdpt_soa.py:52-54)."""
    return msoa.supports_soa_materials(scene)


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


@profiling.span("gdpt.primary")
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
    bhit, bgn = trs.intersect_soa_gn(static, sc.geom, borg, bdir, 0.0, tfar)
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


def _n_iters(static):
    """The bounces after which _gdpt_bounce retires every lane."""
    md = static.options.max_depth
    return GDPT_MAX_DEPTH if md < 0 else min(md, GDPT_MAX_DEPTH)


def _count(key, k, device):
    """Adds k to WORK[key], but not while a CUDA graph is captured: the
    capture runs nothing, and _gdpt_pass counts its replays."""
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        WORK[key] += k


@profiling.span("gdpt.bounce")
def _gdpt_bounce(static, sc: ps.SceneSoA, used, seed, s, pool_sort=False):
    """One shared GDPT bounce over per-lane state (lanes may sit at
    different depths: bounce/pixel/sample are per-lane, so both the
    banded sample loop and the wavefront pool run this same body).
    s carries the scalar ray counter in s["rays"]. pool_sort: the pool
    is morton-sorted (_gdpt_pool_sort), so the base extension cast and
    the 8n probe/replay cast (eight pool-ordered groups) skip their own
    sort; the NEE shadow cast keeps it."""
    n_iters = _n_iters(static)
    n = s["prob"].shape[0]
    _count("bounces", 1, s["prob"].device)
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
    nxt_hit, nxt_gn = trs.intersect_soa_gn(static, sc.geom, base_v.position, samp.dir_out,
                                           eps_isect, torch.where(extend, BIG, -1.0),
                                           sort_rays=not pool_sort)
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
    bhit, bgn = trs.intersect_soa_gn(static, sc.geom, borg, bdir, eps_isect, btfar,
                                     sort_rays=not pool_sort)

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
    uint32 values, as Python ints or as 0-d int64 tensors on the lanes'
    device (a captured sample's inputs, banded.sample_pass); both forms
    give the same bits.

    At max_depth > 0 the bounce runs its most trips, n_iters + 1
    (_gdpt_bounce retires every lane after bounce n_iters), and a bounce
    over retired lanes adds nothing; otherwise it runs until every lane
    is retired, which reads the lanes on the host each bounce."""
    used = static.used_material_kinds
    n = ray_idx.shape[0]
    del xs, ys  # pixel coords derive from ray_idx (the pixel index)
    dev = ray_idx.device
    pixel = ray_idx.to(torch.int64)
    sample = torch.zeros(n, dtype=torch.int64, device=dev).add_(sample0).bitwise_and_(ps._M32)
    state = _init_gdpt_lanes(static, camera, sc, pixel, sample, seed,
                             torch.ones(n, dtype=torch.bool, device=dev))
    _count("samples", n, dev)
    state["rays"] = torch.full((), 5.0 * n, dtype=REAL, device=dev)
    if static.options.max_depth > 0:
        for _ in range(_n_iters(static) + 1):
            state = _gdpt_bounce(static, sc, used, seed, state)
    else:
        while bool((state["active"] > 0).any()):
            state = _gdpt_bounce(static, sc, used, seed, state)

    # Accumulated per-prefix terms (reference pairing:
    # src/path_tracing.h:1016-1049, small_gdpt.cpp:488-507 — but one
    # term per light hit instead of one product at loop end).
    return (GdptSampleSoA(state["radiance"], state["primal_bf"], *state["diffs"]),
            state["rays"])


def _gdpt_wavefront_body(static, camera, sc, used, st, pool_sort=False):
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
        WORK["samples"] += n_take
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
    lane = _gdpt_bounce(static, sc, used, st["seed"], lane, pool_sort)
    return dict(st, lane=lane, pending=pending2, next_item=next_item,
                occ_sum=st["occ_sum"] + occ, iters=st["iters"] + 1)


def _sort_lane_pool(st, tab, org: V3, d: V3, live):
    """Morton-permute a lane pool of st["lane"] and st["pending"] by the
    rays (org, d) (path_soa.pool_perm): pending permutes with the lanes
    (it is per-lane bookkeeping), the lane dict's scalar ray count stays.
    Shared by volpath_soa."""
    perm = ps.pool_perm(tab, org, d, live)

    def take(a):
        return a[perm]

    lane = {k: (v if k == "rays" else soa.tree_map(take, v)) for k, v in st["lane"].items()}
    return dict(st, lane=lane, pending=take(st["pending"]))


def _gdpt_pool_sort(st, tab):
    """Morton-permute the 5-path lane pool: the key is the base vertex's
    position and the incoming direction's octant."""
    s = st["lane"]
    return _sort_lane_pool(st, tab, s["base_v"].position, s["base_d"], s["active"] > 0)


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
                          pool=1 << 17, compact=True, pool_sort=False):
    """Run the GDPT wavefront to completion; returns (acc (6,3,n) f64
    sample sums, total_rays). pool: lane-pool width asked for (cut to the
    work, in whole dispatch quanta); compact: tail compaction; pool_sort:
    morton-sort the pool before every chunk of k_iters iterations (BVH
    scenes only; _gdpt_pool_sort). The
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
        with profiling.span("render.readback"):
            packet_kernels.check_overflow()
            part = st["acc"].cpu().numpy()
        with profiling.span("render.image"):
            host_acc[...] += part.astype(np.float64)
        st["acc"].zero_()

    if sc.geom.packet is None and not static.use_brute_force:
        trs.refuse_without_table(pool_sort=pool_sort)
    pool_sort = pool_sort and sc.geom.packet is not None
    cur_pool = pool
    while True:
        if pool_sort:
            st = _gdpt_pool_sort(st, sc.geom.packet)
        for _ in range(k_iters):
            st = _gdpt_wavefront_body(static, camera, sc, used, st, pool_sort)
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
    with profiling.span("render.image"):
        acc = host_acc.T.reshape(6, 3, n_pix)
    _gdpt_wavefront_accum.last_occupancy = float(st["occ_sum"]) / max(st["iters"], 1)
    _gdpt_wavefront_accum.last_iters = st["iters"]
    GRAPHS["eager"] += spp
    return acc, float(st["lane"]["rays"])


_gdpt_wavefront_accum.last_iters = 0
_gdpt_wavefront_accum.last_occupancy = 0.0


def _add_gdpt_sample(static, camera, sc, lanes, seed, sample, acc, rays):
    """One sample of trace_gdpt_soa added into the pass's sums in place:
    acc (18, n) f32, the x, y, z rows of GdptSampleSoA's six buffers in
    order, and rays, an f32 0-d tensor."""
    out, nr = trace_gdpt_soa(static, camera, sc, *lanes, seed, sample)
    for row, c in zip(acc, (c for buf in out for c in buf)):
        row.add_(c)
    rays.add_(nr)


def _gdpt_pass(static, camera, sc, xs, ys, ray_idx, seed, sample0, n_samples):
    """n_samples GDPT samples summed in f32 for the whole ray batch;
    returns (the (18, n) sums, total rays as an f32 0-d tensor):
    banded.sample_pass over _add_gdpt_sample, replayed (CUDA lanes,
    brute force, max_depth > 0) or eager. A replay runs no Python, so
    its samples and bounces are counted in WORK here."""
    acc, rays, replayed = banded.sample_pass(_add_gdpt_sample, 18, GRAPHS, static, camera, sc,
                                             xs, ys, ray_idx, seed, sample0, n_samples)
    if replayed:
        WORK["samples"] += xs.shape[0] * n_samples
        WORK["bounces"] += (_n_iters(static) + 1) * n_samples
    return acc, rays


def render_gradpath_soa(scene: Scene, spp=None, seed=0, return_aux=False,
                        return_stats=False, wavefront=None, pool=1 << 17, compact=True,
                        pool_sort=False, packet_wide=32, packet_dual=False, start_sample=0,
                        init_acc=None, on_chunk=None, mesh=None, **cast):
    """SoA GDPT render on the scene's device: accumulate primal + 4
    gradient buffers, then screened-Poisson reconstruct (reference:
    src/render.cpp:257-370). Returns the (h, w, 3) float32 numpy
    reconstruction; with return_aux also a dict of the primal, primal_bf,
    gx and gy images, with return_stats the traced ray count.

    wavefront (None, True or False), start_sample, init_acc, on_chunk
    and mesh choose the wavefront lane pool or the banded loop
    (banded.route). pool, compact and pool_sort are the wavefront's lane
    count, tail compaction and pool sort. packet_wide (16
    or 32) is the width of a BVH scene's packet table; packet_dual=True
    walks a 16-wide table with the dual kernel K4 in place of K3 (with
    width 32 it raises ValueError); **cast (two_phase, packet_sort,
    premerge, entry_k, packet, max_table_mb): see
    path_soa.scene_soa_from_aos.

    The banded loop (banded.loop) resumes from start_sample and init_acc
    (the raw (6, 3, n) float64 sample sums: primal, brute-force primal
    and the four one-sided gradients, before the Poisson solve), calls
    on_chunk(acc, done) after every pass, and over a mesh
    (parallel/sharding.Mesh) pads each band's rays as the reference pads
    them (to the first band's width, then to whole 128-lane groups per
    device) and counts a band's rays as the reference does: the rays its
    padded lanes traced, scaled by its share of real lanes."""
    static = scene.static
    w, h = static.width, static.height
    spp = spp if spp is not None else static.options.samples_per_pixel
    n = w * h
    wavefront = banded.route(wavefront, static, n, spp, start_sample, init_acc, on_chunk, mesh)
    # A sharded render solves the Poisson equation on the mesh's first device.
    device = scene.device.camera.sample_to_cam.device if mesh is None else mesh.devices[0]
    seed = int(seed) & ps._M32

    def finish(acc, total_rays):
        return _gdpt_finish(static, acc, spp, w, h, total_rays, return_aux, return_stats, device)

    if wavefront:
        sc = ps.scene_soa_from_aos(scene, packet_wide, packet_dual, **cast)
        return finish(*_gdpt_wavefront_accum(static, scene.device.camera, sc, spp, seed, n,
                                             pool=pool, compact=compact, pool_sort=pool_sort))

    # The 5-path state is large: big BVH images go through in equal
    # bands of pixels, as in the reference.
    if static.use_brute_force or n <= PIX_CAP:
        bands = [(0, n)]
    else:
        nb = -(-n // PIX_CAP)
        band = -(-n // nb)
        bands = [(lo, min(n, lo + band)) for lo in range(0, n, band)]

    def view(scene_d):
        return scene_d.device.camera, ps.scene_soa_from_aos(scene_d, packet_wide, packet_dual,
                                                            **cast)

    def sample(v, xs, ys, ray_idx, done, k):
        return _gdpt_pass(static, *v, xs, ys, ray_idx, seed, done, k)

    # About 5x the rays of a plain path sample per GDPT sample.
    return banded.loop(scene, spp, view, sample, (6, 3), 1 << 23, start_sample, init_acc,
                       on_chunk, mesh, finish, bands=bands, real_share=True)


def _gdpt_finish(static, acc, spp, w, h, total_rays, return_aux, return_stats, device):
    """Shared tail: (6,3,n) sample sums -> Poisson reconstruction, solved
    on `device`: the host's images in render.image, the solve in
    gdpt.solve."""
    with profiling.span("render.image"):
        primal, primal_bf, gxh, gxn, gyh, gyn = (
            (acc[i] / spp).T.reshape(h, w, 3).astype(np.float32) for i in range(6))
    with profiling.span("gdpt.solve"):
        gx, gy = poisson.assemble_gradients(
            *(torch.as_tensor(a, device=device) for a in (gxh, gxn, gyh, gyn)))
        recon = poisson.screened_poisson_solve(
            torch.as_tensor(primal, device=device), gx, gy, static.options.gdpt_alpha
        ).cpu().numpy()
    with profiling.span("render.image"):
        recon = np.where(np.isfinite(recon), recon, 0.0).astype(np.float32)
    if return_aux:
        aux = dict(primal=primal, primal_bf=primal_bf,
                   gx=gx.cpu().numpy(), gy=gy.cpu().numpy())
    if return_aux and return_stats:
        return recon, aux, total_rays
    if return_aux:
        return recon, aux
    if return_stats:
        return recon, total_rays
    return recon
