"""Batched (SoA) surface path tracer on tensors.

Counterpart of gdpt_tpu/integrators/path_soa.py: NEE + power-2 MIS +
Russian roulette (reference: src/path_tracing.h:13-348) over (N,)
component tensors, with the same RNG streams and use-site counters, so
that at low spp the port is held against the reference pixel by pixel.

Ported: the banded loop's sample (``trace_paths_soa``, run by
integrators/banded.py's loop) and the wavefront renderer
(``render_soa_wavefront``, the default for BVH scenes) behind
``render_soa``, with every material kind and texture slot of
ops/materials_soa.py (image textures mip-filtered by the ray
differentials' footprint), mesh and sphere area lights and constant or
image envmaps; integrators/gdpt_soa.py builds the gradient-domain render
on the same pieces; the banded loop resumes a checkpointed render
(start_sample, init_acc, on_chunk) and runs with its rays sharded over
a mesh of devices (mesh=, parallel/sharding.py). The wavefront can keep
its lane pool morton-sorted (pool_sort=True, _pool_sort). The banded
sample of a brute-force Lambertian scene lit by mesh lights, on CUDA
lanes, runs as integrators/path_fused.py's stage kernels between the
casts (_soa_pass), with trace_paths_soa's bits. The pieces at one
vertex (shade_hit, NEE, the camera rays) are integrators/vertex_soa.py's.

Every tensor is made on the device the scene lives on.
"""

import numpy as np
import torch

from gdpt_tpu_torch.accel import packet_kernels, packet_trace
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import distributions as gdist
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL, asarray
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import banded, path_fused
from gdpt_tpu_torch.integrators.vertex_soa import (
    _CTR_BSDF_UV, _CTR_BSDF_W, _CTR_LIGHT_UV, _CTR_LIGHT_W, _CTR_PIXEL, _CTR_STRIDE,
    HARD_BOUNCE_CAP, SceneSoA, _env_view, emission, hit_light_pdf_soa, nee_soa,
    primary_rays_soa, shade_hit)
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.ops import textures_soa as tsoa
from gdpt_tpu_torch.scene.build import Scene, SceneMemo
from gdpt_tpu_torch.utils import profiling



def _footprint_constants(dev):
    """Per-triangle footprint constants on the host (reference:
    src/intersection.cpp:33-56): inv_uv_size = max(|dpdu|, |dpdv|) and
    the mean curvature from dn/du, dn/dv at the centroid shading normal
    (the reference's deliberate approximation, path_soa.py:239-251)."""
    idx = dev.tri_index.cpu().numpy()
    vn = dev.vtx_normal.cpu().numpy()
    vuv = dev.vtx_uv.cpu().numpy()
    if not idx.shape[0]:
        z3 = np.zeros((0, 3), np.float32)
        z2 = np.zeros((0, 2), np.float32)
        z = np.zeros(0, np.float32)
        return (z3, z3, z3), (z2, z2, z2), z, z
    n0, n1, n2 = vn[idx[:, 0]], vn[idx[:, 1]], vn[idx[:, 2]]
    uv0, uv1, uv2 = vuv[idx[:, 0]], vuv[idx[:, 1]], vuv[idx[:, 2]]
    e1c = dev.geom.tri_e1.cpu().numpy()
    e2c = dev.geom.tri_e2.cpu().numpy()
    dpds, dpdt = e2c, e2c - e1c          # p2-p0, p2-p1
    # Fallback bary uvs ((0,0),(1,0),(1,1)) when the mesh has no uvs.
    huv = (dev.tri_has_uvs.cpu().numpy() > 0)[:, None]
    uv0d = np.where(huv, uv0, np.float32([0.0, 0.0]))
    uv1d = np.where(huv, uv1, np.float32([1.0, 0.0]))
    uv2d = np.where(huv, uv2, np.float32([1.0, 1.0]))
    duvds = uv2d - uv0d
    duvdt = uv2d - uv1d
    det = duvds[:, 0] * duvdt[:, 1] - duvdt[:, 0] * duvds[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = np.where(det != 0, 1.0 / np.where(det != 0, det, 1), 0)
    dsdu = duvdt[:, 1] * inv_det
    dtdu = -duvds[:, 1] * inv_det
    dsdv = -duvdt[:, 0] * inv_det
    dtdv = duvds[:, 0] * inv_det
    dpdu = dpds * dsdu[:, None] + dpdt * dtdu[:, None]
    dpdv = dpds * dsdv[:, None] + dpdt * dtdv[:, None]
    degen = np.abs(det) <= 1e-8
    inv_uv = np.where(
        degen, 1.0,
        np.maximum(np.linalg.norm(dpdu, axis=1),
                   np.linalg.norm(dpdv, axis=1))).astype(np.float32)
    gn_h = np.cross(e1c, e2c)
    sn_h = n0 + n1 + n2
    nrm = np.linalg.norm(sn_h, axis=1, keepdims=True)
    sn_h = np.where(nrm > 1e-20, sn_h / np.maximum(nrm, 1e-20),
                    gn_h / np.maximum(
                        np.linalg.norm(gn_h, axis=1, keepdims=True),
                        1e-20))
    tan = dpdu - sn_h * (sn_h * dpdu).sum(1, keepdims=True)
    tn = np.linalg.norm(tan, axis=1, keepdims=True)
    tan = tan / np.maximum(tn, 1e-20)
    bit = np.cross(sn_h, tan)
    bit /= np.maximum(np.linalg.norm(bit, axis=1, keepdims=True), 1e-20)
    dnds, dndt = n2 - n0, n2 - n1
    dndu = dnds * dsdu[:, None] + dndt * dtdu[:, None]
    dndv = dnds * dsdv[:, None] + dndt * dtdv[:, None]
    has_n_h = dev.tri_has_normals.cpu().numpy() > 0
    mc = np.where(
        has_n_h,
        0.5 * ((dndu * tan).sum(1) + (dndv * bit).sum(1)),
        0.0).astype(np.float32)
    return (n0, n1, n2), (uv0, uv1, uv2), inv_uv, mc


def supports_soa(scene: Scene) -> bool:
    """The SoA fast path covers the full material stack and every light
    type, so every "path" scene (reference:
    gdpt_tpu/integrators/path_soa.py:112-119); render.render and
    render_with_checkpoints take integrators/path.py where it is False."""
    if scene.static.options.integrator != "path":
        return False
    return msoa.supports_soa_materials(scene)


_SOA_MEMO = SceneMemo()


def scene_soa_from_aos(scene: Scene, wide=32, dual=False, two_phase=False, packet_sort=True,
                       premerge=False, entry_k=packet_trace.ENTRY_K, packet=True,
                       max_table_mb=None) -> SceneSoA:
    """The render's view of `scene`, built once per scene and table
    build: the host-side prep (packet table, alias tables, footprint
    constants) is pure in these and takes seconds on a large scene.
    wide: the packet table's supernode width, 16 or 32; premerge and
    entry_k: its build switches (packet_trace.build_packet_table). dual:
    walk it with the dual kernel K4 (16-wide only) instead of K3;
    two_phase: casts of 4,096 rays or more take the two-phase entry
    traversal; packet_sort=False: no cast sorts its rays. The walk's
    switches are static flags of the view over the same tables.
    packet=False and max_table_mb (the reference's GDPT_PACKET=0 and
    GDPT_MAX_TABLE_MB) pick the reference's XLA walks instead of the
    table (traverse_soa.geom_soa_from_aos); both are in the memo's key,
    as they change what is built, and on a BVH scene left without a
    table the walk's switches raise ValueError."""
    if dual and wide != 16:
        raise ValueError(f"packet_dual=True needs packet_wide=16, got {wide!r}")
    build = (wide, bool(premerge), int(entry_k), bool(packet),
             None if max_table_mb is None else int(max_table_mb))
    sc = _SOA_MEMO.get(scene.device, build, lambda: _scene_soa_from_aos(scene, *build))
    if sc.geom.packet is None and not scene.static.use_brute_force:
        trs.refuse_without_table(packet_dual=dual, two_phase=two_phase,
                                 packet_sort=not packet_sort)
    if sc.geom.packet is not None and (dual or two_phase or not packet_sort):
        sc = sc._replace(geom=sc.geom._replace(dual=bool(dual), two_phase=bool(two_phase),
                                               packet_sort=bool(packet_sort)))
    return sc


def _scene_soa_from_aos(scene: Scene, wide, premerge, entry_k, packet,
                        max_table_mb) -> SceneSoA:
    dev = scene.device
    device = dev.geom.tri_v0.device

    def put(x, dtype=None):
        return asarray(x, dtype, device)

    env_w = dev.envmap.dist.pdf_marginals.cpu().numpy().astype(np.float64)[:, None] \
        * dev.envmap.dist.pdf_rows.cpu().numpy().astype(np.float64)
    env_alias_cut, env_alias_idx = gdist.build_alias_table(env_w)
    (n0, n1, n2), (uv0, uv1, uv2), inv_uv, mc = _footprint_constants(dev)
    t_shape = dev.geom.tri_shape_id.long()
    tri_mat = dev.shape_material_id[t_shape].to(INT)
    tri_lgt = dev.shape_light_id[t_shape].to(INT)
    env_rgb = dev.envmap.tex.value[0]
    if scene.static.envmap_is_image:
        eid = int(dev.envmap.tex.img_id[0])
        p3 = dev.pool3
        eoff, ew, eh = (int(a[eid, 0]) for a in (p3.level_offset, p3.level_w, p3.level_h))
        env_img3 = p3.data[eoff:eoff + eh * ew].contiguous()
    else:
        env_img3 = torch.zeros((1, 3), dtype=REAL, device=device)
    return SceneSoA(
        geom=trs.geom_soa_from_aos(dev.geom, wide=wide, premerge=premerge, entry_k=entry_k,
                                   packet=packet, max_table_mb=max_table_mb),
        tri_n0=soa.from_rows(put(n0)),
        tri_n1=soa.from_rows(put(n1)),
        tri_n2=soa.from_rows(put(n2)),
        tri_uv0_u=put(uv0[:, 0]), tri_uv0_v=put(uv0[:, 1]),
        tri_uv1_u=put(uv1[:, 0]), tri_uv1_v=put(uv1[:, 1]),
        tri_uv2_u=put(uv2[:, 0]), tri_uv2_v=put(uv2[:, 1]),
        tri_shape_id=dev.geom.tri_shape_id,
        tri_has_normals=dev.tri_has_normals,
        tri_has_uvs=dev.tri_has_uvs,
        tri_material_id=tri_mat,
        tri_light_id=tri_lgt,
        tri_inv_uv=put(inv_uv),
        tri_mean_curv=put(mc),
        sph_shape_id=dev.geom.sph_shape_id,
        shape_kind=dev.shape_kind,
        shape_material_id=dev.shape_material_id,
        shape_light_id=dev.shape_light_id,
        shape_area=dev.shape_area,
        shape_prim_offset=dev.shape_prim_offset,
        shape_interior_medium=dev.shape_interior_medium,
        shape_exterior_medium=dev.shape_exterior_medium,
        mat_tables=msoa.build_material_tables(dev),
        light_kind=dev.lights.kind,
        light_shape_id=dev.lights.shape_id,
        light_intensity=soa.from_rows(dev.lights.intensity),
        light_tri_cdf=dev.lights.tri_cdf,
        light_tri_first=dev.lights.tri_first,
        light_pmf=dev.lights.pmf,
        light_cdf=dev.lights.cdf,
        env_value=V3(env_rgb[0], env_rgb[1], env_rgb[2]),
        env_to_world=dev.envmap.to_world,
        env_to_local=dev.envmap.to_local,
        env_scale=dev.envmap.scale,
        env_img_id=dev.envmap.tex.img_id[0],
        env_cdf_rows=dev.envmap.dist.cdf_rows,
        env_pdf_rows=dev.envmap.dist.pdf_rows,
        env_cdf_marginals=dev.envmap.dist.cdf_marginals,
        env_pdf_marginals=dev.envmap.dist.pdf_marginals,
        env_alias_cut=env_alias_cut.to(device),
        env_alias_idx=env_alias_idx.to(device),
        env_img3=env_img3,
    )


def trace_paths_soa(static, camera, sc: SceneSoA, xs, ys, ray_idx, seed, sample0):
    """One sample for every ray in the batch; returns (radiance V3, rays
    per lane). seed and sample0 are uint32 values, as Python ints or as
    0-d int64 tensors on the lanes' device (a captured sample's inputs,
    _soa_pass); both forms give the same bits.

    Program spans (utils/profiling) of each stage: path.primary (the
    pixel draws and camera rays), path.shade (each shade_hit), path.nee,
    path.bsdf (the material gather, the lobe's sample, eval and pdf),
    path.mis (emission and the MIS of BSDF-sampled hits), path.update
    (Russian roulette and the state's updates); the casts are
    traverse_soa's cast.closest and cast.shadow."""
    span = profiling.span
    used = static.used_material_kinds
    w, h = static.width, static.height
    n = xs.shape[0]
    max_depth = static.options.max_depth
    n_iters = HARD_BOUNCE_CAP if max_depth < 0 else max(max_depth - 1, 0)

    def uni2(bounce, ctr):
        return soa.uniform2(seed, ray_idx, bounce * _CTR_STRIDE + ctr, sample0)

    # Primary ray with filter importance sampling.
    with span("path.primary"):
        u0, u1 = uni2(0, _CTR_PIXEL)
        org, d = primary_rays_soa(static, camera, xs, ys, u0, u1)

        # Ray differentials (reference: src/ray.h:36-38).
        zero = torch.zeros(n, dtype=REAL, device=xs.device)
        spread = torch.full((n,), 0.25 / max(w, h), dtype=REAL, device=xs.device)
    hit, gn_raw = trs.intersect_soa_gn(static, sc.geom, org, d, 0.0, BIG)
    with span("path.shade"):
        vertex = shade_hit(static, sc, org, d, hit, gn_raw,
                           ray_radius=zero, ray_spread=spread)
    with span("path.mis"):
        rays = torch.ones(n, dtype=REAL, device=xs.device)
        zero3 = V3(zero, zero, zero)
        radiance = soa.where(vertex.valid > 0, emission(sc, vertex, -d), zero3)
        if static.has_envmap:
            env_primary = tsoa.envmap_emission_soa(_env_view(static, sc), sc.mat_tables.pool3,
                                                   d, spread=spread)
            radiance = soa.where(vertex.valid > 0, radiance, env_primary)
    if n_iters == 0:
        return radiance, rays

    throughput = V3(zero + 1.0, zero + 1.0, zero + 1.0)
    eta_scale = zero + 1.0
    active = vertex.valid > 0
    eps_shadow = static.shadow_epsilon
    eps_isect = static.intersection_epsilon
    bounce = 0
    # max_depth > 0: the reference's fixed trip count (fori_loop);
    # otherwise its while loop, which stops once every lane is retired.
    while bounce < n_iters and (max_depth > 0 or bool(active.any())):
        v = vertex
        b = bounce + 1
        dir_view = -d
        with span("path.bsdf"):
            params = msoa.gather_params_soa(
                sc.mat_tables, used, v.material_id, v.uv_u, v.uv_v,
                static.spec_image_slots, float_tex_slots=static.float_tex_slots, fp=v.fp,
            )

        # ---- NEE (reference: src/path_tracing.h:115-227) ----
        if static.n_lights > 0:
            with span("path.nee"):
                lu0, lu1 = uni2(b, _CTR_LIGHT_UV)
                lw, lsw = uni2(b, _CTR_LIGHT_W)
                nee, shadow_mask = nee_soa(static, sc, v, params, dir_view,
                                           used, lu0, lu1, lw, lsw, active)
                radiance = radiance + throughput * nee
                rays = rays + shadow_mask

        # ---- BSDF sampling (reference: src/path_tracing.h:232-345) ----
        with span("path.bsdf"):
            bu0, bu1 = uni2(b, _CTR_BSDF_UV)
            w_lobe, u_rr = uni2(b, _CTR_BSDF_W)
            samp = msoa.sample_bsdf_soa(params, dir_view, v.gn, v.frame, bu0, bu1,
                                        w_lobe, used)
            d_out = samp.dir_out
            f_b = msoa.eval_bsdf_soa(params, dir_view, d_out, v.gn, v.frame, used)
            pdf_b = msoa.pdf_bsdf_soa(params, dir_view, d_out, v.gn, v.frame, used)
        with span("path.update"):
            active = active & (samp.valid > 0) & (pdf_b > 0)
            rays = rays + active.to(REAL)
            is_tr = samp.eta != 0
            new_eta_scale = torch.where(
                is_tr, eta_scale / torch.where(is_tr, samp.eta, 1.0) ** 2, eta_scale)
            # Ray-differential spread update (reference: src/ray.h:41-57).
            spec_spread = spread + 2.0 * v.mean_curv * v.radius
            spec_spread = torch.where(
                is_tr, spec_spread / torch.where(is_tr, samp.eta, 1.0), spec_spread)
            new_spread = torch.clamp_min(
                spec_spread * (1.0 - samp.roughness) + 0.2 * samp.roughness, 0.0)
            # Retired lanes are dead rays (tfar < tnear): no test, a miss.
            tfar = torch.where(active, BIG, -1.0)

        nxt_hit, nxt_gn = trs.intersect_soa_gn(
            static, sc.geom, v.position, d_out, eps_isect, tfar)
        with span("path.shade"):
            nxt = shade_hit(static, sc, v.position, d_out, nxt_hit, nxt_gn,
                            ray_radius=v.radius, ray_spread=new_spread)
        with span("path.mis"):
            nxt_ok = nxt.valid > 0
            dist2 = soa.length_squared(nxt.position - v.position)
            g2 = torch.where(
                nxt_ok,
                torch.abs(soa.dot(d_out, nxt.gn)) / torch.clamp_min(dist2, 1e-20),
                1.0,
            )
            p2a = pdf_b * g2

            # Emissive hit with MIS (reference: src/path_tracing.h:291-325).
            if static.n_lights > 0:
                hit_light = nxt_ok & (nxt.light_id >= 0) & active
                l_emit = emission(sc, nxt, -1.0 * d_out)
                p1h = hit_light_pdf_soa(static, sc, v.position, nxt, d_out, dist2)
                w2 = p2a * p2a / torch.clamp_min(p1h * p1h + p2a * p2a, 1e-30)
                scale = g2 * w2 / torch.clamp_min(p2a, 1e-30)
                contrib = throughput * f_b * l_emit * scale
                radiance = radiance + soa.where(hit_light, contrib, zero3)
            if static.has_envmap:
                # A bounce that leaves the scene sees the envmap, MIS-weighted
                # against its NEE sampler.
                miss = active & ~nxt_ok
                env_hit, env_pdf = tsoa.envmap_emission_pdf_soa(
                    _env_view(static, sc), sc.mat_tables.pool3, d_out)
                p1e = sc.light_pmf[static.envmap_light_id] * env_pdf
                w2e = p2a * p2a / torch.clamp_min(p1e * p1e + p2a * p2a, 1e-30)
                scale = g2 * w2e / torch.clamp_min(p2a, 1e-30)
                contrib = throughput * f_b * env_hit * scale
                radiance = radiance + soa.where(miss, contrib, zero3)

        with span("path.update"):
            active = active & nxt_ok

            # Russian roulette (reference: src/path_tracing.h:334-341).
            new_tp = throughput * f_b * (g2 / torch.clamp_min(p2a, 1e-30))
            num_vertices = bounce + 3
            if (num_vertices - 1) >= static.options.rr_depth:
                rr_prob = torch.clamp_max(
                    soa.vmax(new_tp) / torch.clamp_min(new_eta_scale, 1e-20), 0.95)
                active = active & (u_rr <= rr_prob)
            else:
                rr_prob = zero + 1.0
            new_tp = new_tp * (1.0 / torch.clamp_min(rr_prob, 1e-20))
            throughput = soa.where(active, new_tp, throughput)

            vertex = soa.tree_where(active, nxt, v)
            eta_scale = torch.where(active, new_eta_scale, eta_scale)
            d = soa.where(active, d_out, d)
            spread = torch.where(active, new_spread, spread)
        bounce += 1
    return radiance, rays


_M32 = 0xFFFFFFFF

# A wavefront dispatch is sized in whole quanta of this many lanes (the
# reference's 1024-ray packet), so pool widths match the reference's.
LANE_QUANTUM = 1024


def _wavefront_body(static, camera, sc, st, pool_sort=False):
    """One wavefront iteration: regenerate dead lanes with the next
    (pixel, sample) work items, trace pending rays, collect emitter
    or envmap radiance with carried-pdf MIS, NEE, sample the next bounce, RR.

    Estimator-identical to trace_paths_soa (same RNG streams/counters per
    (pixel, sample), same MIS/RR math) but runs a fixed-size lane pool at
    ~full occupancy instead of letting the whole image drain to its
    slowest path. This is the wavefront analog of the reference's
    per-thread serial loop (src/render.cpp:82-117) — sample regeneration
    replaces tile scheduling.

    pool_sort: render_soa_wavefront keeps the pool morton-sorted
    (_pool_sort), so the extension cast skips its own sort; NEE's shadow
    casts, whose directions differ, keep theirs.

    The work queue counts (pixel, sample) items in uint32 arithmetic
    carried in int64 (masked to 32 bits, as core/soa.py's RNG). The
    accumulators of st are updated in place.
    """
    used = static.used_material_kinds
    n_pix = static.width * static.height
    md = static.options.max_depth
    n_iters = HARD_BOUNCE_CAP if md < 0 else max(md - 1, 0)
    P = st["alive"].shape[0]
    device = st["alive"].device
    zero = torch.zeros(P, dtype=REAL, device=device)
    zero3 = V3(zero, zero, zero)
    one3 = V3(zero + 1.0, zero + 1.0, zero + 1.0)
    eps_isect = static.intersection_epsilon
    seed = st["seed"]

    # --- regenerate dead lanes from the work queue ---
    dead = st["alive"] <= 0
    rank = torch.cumsum(dead.to(torch.int64), dim=0) - 1
    item = (st["next_item"] + torch.where(dead, rank, 0)) & _M32
    # item >= next_item also rejects uint32 wraparound of next_item +
    # rank for totals just below 2^32 (a wrapped item would alias an
    # early (pixel, sample) and drop the true tail).
    fresh = dead & (item < st["total"]) & (item >= st["next_item"])
    pixel = torch.where(fresh, item % n_pix, st["pixel"])
    sample = torch.where(fresh, item // n_pix, st["sample"])
    xs = (pixel % static.width).to(REAL)
    ys = (pixel // static.width).to(REAL)
    u0, u1 = soa.uniform2(seed, pixel, _CTR_PIXEL, sample)
    porg, pd = primary_rays_soa(static, camera, xs, ys, u0, u1)
    org = soa.where(fresh, porg, st["org"])
    d = soa.where(fresh, pd, st["d"])
    tp = soa.where(fresh, one3, st["tp"])
    pdf_prev = torch.where(fresh, 0.0, st["pdf_prev"])
    eta_scale = torch.where(fresh, 1.0, st["eta_scale"])
    bounce = torch.where(fresh, 0, st["bounce"])
    alive = fresh | (st["alive"] > 0)
    # rr_prev: survival prob divided out of tp at sample time; the
    # emission collected at this ray's hit must NOT carry that division
    # (the banded loop adds the emitter-hit contribution before RR).
    # cont: RR verdict — a killed lane still traces this ray for its
    # emission, then dies (matching the banded loop's trace-then-kill).
    rr_prev = torch.where(fresh, 1.0, st["rr_prev"])
    cont = fresh | (st["cont"] > 0)
    next_item = (st["next_item"] + fresh.sum()) & _M32
    # Ray differentials: fresh lanes restart at radius 0 / camera spread
    # (reference: src/ray.h:36-38).
    radius = torch.where(fresh, 0.0, st["radius"])
    spread = torch.where(fresh, 0.25 / max(static.width, static.height),
                         st["spread"])

    # --- trace pending rays (primary tnear = 0, bounce tnear = eps) ---
    tnear = torch.where(bounce == 0, 0.0, eps_isect)
    tfar = torch.where(alive, BIG, -1.0)
    hit, gn_raw = trs.intersect_soa_gn(static, sc.geom, org, d, tnear, tfar,
                                       sort_rays=not pool_sort)
    v = shade_hit(static, sc, org, d, hit, gn_raw,
                  ray_radius=radius, ray_spread=spread)
    rays = st["rays"] + alive.to(REAL).sum()
    v_ok = (v.valid > 0) & alive
    miss = alive & (v.valid <= 0)
    is_primary = pdf_prev <= 0

    # --- radiance carried into this hit (reference:
    # src/path_tracing.h:291-325; carried-pdf form of the banded MIS) ---
    contrib = zero3
    tp_emit = tp * rr_prev
    if static.n_lights > 0:
        hit_is_light = v_ok & (v.light_id >= 0)
        l_emit = emission(sc, v, -1.0 * d)
        dist2 = soa.length_squared(v.position - org)
        g2 = torch.abs(soa.dot(d, v.gn)) / torch.clamp_min(dist2, 1e-20)
        p2a = pdf_prev * g2
        p1h = hit_light_pdf_soa(static, sc, org, v, d, dist2)
        w2 = p2a * p2a / torch.clamp_min(p1h * p1h + p2a * p2a, 1e-30)
        wgt = torch.where(is_primary, 1.0, w2)
        contrib = contrib + soa.where(hit_is_light, tp_emit * l_emit * wgt, zero3)
    if static.has_envmap:
        env, env_pdf = tsoa.envmap_emission_pdf_soa(
            _env_view(static, sc), sc.mat_tables.pool3, d)
        p1e = sc.light_pmf[static.envmap_light_id] * env_pdf
        w2e = pdf_prev * pdf_prev / torch.clamp_min(p1e * p1e + pdf_prev * pdf_prev, 1e-30)
        wgt = torch.where(is_primary, 1.0, w2e)
        contrib = contrib + soa.where(miss, tp_emit * env * wgt, zero3)

    # --- NEE + next bounce at the hit vertex ---
    b = bounce + 1

    def ctr(c):
        return b.to(torch.int64) * _CTR_STRIDE + c

    ext = v_ok & cont & (bounce < n_iters)
    params = msoa.gather_params_soa(
        sc.mat_tables, used, v.material_id, v.uv_u, v.uv_v,
        static.spec_image_slots, float_tex_slots=static.float_tex_slots, fp=v.fp)
    dir_view = -d
    if static.n_lights > 0:
        lu0, lu1 = soa.uniform2(seed, pixel, ctr(_CTR_LIGHT_UV), sample)
        lw, lsw = soa.uniform2(seed, pixel, ctr(_CTR_LIGHT_W), sample)
        nee, shadow_mask = nee_soa(static, sc, v, params, dir_view, used,
                                   lu0, lu1, lw, lsw, ext)
        contrib = contrib + tp * nee
        rays = rays + shadow_mask.sum()

    bu0, bu1 = soa.uniform2(seed, pixel, ctr(_CTR_BSDF_UV), sample)
    w_lobe, u_rr = soa.uniform2(seed, pixel, ctr(_CTR_BSDF_W), sample)
    samp = msoa.sample_bsdf_soa(params, dir_view, v.gn, v.frame,
                                bu0, bu1, w_lobe, used)
    f_b = msoa.eval_bsdf_soa(params, dir_view, samp.dir_out, v.gn, v.frame, used)
    pdf_b = msoa.pdf_bsdf_soa(params, dir_view, samp.dir_out, v.gn, v.frame, used)
    valid = ext & (samp.valid > 0) & (pdf_b > 0)
    is_tr = samp.eta != 0
    eta2 = torch.where(
        is_tr, eta_scale / torch.where(is_tr, samp.eta, 1.0) ** 2, eta_scale)
    # Spread update for the sampled bounce (reference: src/ray.h:41-57).
    spec_spread = spread + 2.0 * v.mean_curv * v.radius
    spec_spread = torch.where(
        is_tr, spec_spread / torch.where(is_tr, samp.eta, 1.0), spec_spread)
    spread_next = torch.clamp_min(
        spec_spread * (1.0 - samp.roughness) + 0.2 * samp.roughness, 0.0)
    tp_new = tp * f_b * (1.0 / torch.clamp_min(pdf_b, 1e-30))

    # Russian roulette (reference: src/path_tracing.h:334-341). The
    # sampled ray is traced either way (next iteration) so its emitter
    # hit is collected; a killed lane stops after that (cont=False),
    # matching the banded loop's add-emission-then-kill ordering.
    do_rr = (bounce + 2) >= static.options.rr_depth
    rr_prob = torch.where(
        do_rr,
        torch.clamp_max(soa.vmax(tp_new) / torch.clamp_min(eta2, 1e-20), 0.95),
        1.0,
    )
    survive = (~do_rr) | (u_rr <= rr_prob)
    tp_new = tp_new * (1.0 / torch.clamp_min(rr_prob, 1e-20))
    alive_next = valid

    # --- accumulate into the image (f32 scatter-add: on CUDA the sum's
    # order is not fixed, so cuda and cpu images agree to a tolerance) ---
    st["acc_x"].index_add_(0, pixel, contrib.x)
    st["acc_y"].index_add_(0, pixel, contrib.y)
    st["acc_z"].index_add_(0, pixel, contrib.z)

    st.update(
        org=soa.where(alive_next, v.position, org),
        d=soa.where(alive_next, samp.dir_out, d),
        tp=soa.where(alive_next, tp_new, tp),
        pdf_prev=torch.where(alive_next, pdf_b, pdf_prev),
        eta_scale=torch.where(alive_next, eta2, eta_scale),
        rr_prev=torch.where(alive_next, rr_prob, rr_prev),
        cont=torch.where(alive_next, survive, cont).to(REAL),
        radius=torch.where(alive_next, v.radius, radius),
        spread=torch.where(alive_next, spread_next, spread),
        pixel=pixel,
        sample=sample,
        bounce=torch.where(alive_next, b, bounce),
        alive=alive_next.to(REAL),
        next_item=next_item,
        rays=rays,
        # Occupancy telemetry: mean live fraction per iteration.
        occ_sum=st["occ_sum"] + alive.to(REAL).mean(),
        iters=st["iters"] + 1,
    )
    return st


# Lane-pool state entries (everything pool-shaped; accumulators and
# scalars stay put when the pool shrinks).
_POOL_KEYS = ("org", "d", "tp", "pdf_prev", "eta_scale", "rr_prev",
              "cont", "radius", "spread", "pixel", "sample", "bounce",
              "alive")


def pool_perm(tab, org: V3, d: V3, live):
    """The permutation of a wavefront pool sort: a stable argsort of the
    lanes' ray morton/octant keys, dead lanes keyed 2^30 (to the back).
    Shared by the gradpath and volpath pools."""
    keys = torch.where(live, packet_trace._morton_keys(tab, org, d), 2 ** 30)
    return torch.argsort(keys, stable=True)


def _pool_sort(st, tab):
    """Morton/octant-permute the wavefront lane pool (pool_perm). A
    lane's identity (pixel, sample) rides with its state, so the
    estimate is unchanged; only which rays share a warp in the walk
    changes."""
    perm = pool_perm(tab, st["org"], st["d"], st["alive"] > 0)
    out = dict(st)
    for k in _POOL_KEYS:
        out[k] = soa.tree_map(lambda a: a[perm], st[k])
    return out


def _compact_take_order(keep, new_pool):
    """Stable keep-first permutation, sliced to the new pool width."""
    return torch.argsort((~keep).to(torch.int8), stable=True)[:new_pool]


def _shrink_pool_state(st, new_pool, pool_keys=_POOL_KEYS, keep=None):
    """Compact live lanes into a fresh pool of width new_pool.

    Tail compaction: once the work queue drains, lanes die at different
    depths and every dispatch would still pay full-width sort, ray cast
    and shading cost. The slots past the live prefix hold dead lanes,
    which regenerate nothing once the queue is empty; accumulators are
    n_pix-shaped and stay put.
    """
    if keep is None:
        keep = st["alive"] > 0
    order = _compact_take_order(keep, new_pool)
    out = dict(st)
    for k in pool_keys:
        out[k] = soa.tree_map(lambda a: a[order], st[k])
    return out


def _tail_bucket(n_alive, cur_pool, lane_q):
    """Target pool width for the drain tail: next power-of-two >=
    n_alive, quantized to whole dispatch quanta, floored at one. Returns
    None unless it at least halves the pool."""
    target = lane_q
    while target < n_alive:
        target *= 2
    target = -(-target // lane_q) * lane_q
    if target <= cur_pool // 2:
        return target
    return None


def _pool_width(total, pool=None):
    """Lane-pool width: 2^18 lanes unless asked otherwise, no wider than
    the work, in whole dispatch quanta."""
    lane_q = LANE_QUANTUM
    if pool is None:
        pool = 1 << 18
    pool = min(pool, -(-total // lane_q) * lane_q)
    return -(-pool // lane_q) * lane_q


def _wavefront_state(n_pix, pool, total, seed, device):
    """The wavefront's state before its first iteration: an all-dead
    lane pool, the work queue at item 0 of `total`, zeroed accumulators."""
    def z(dtype=REAL, n=pool):
        return torch.zeros(n, dtype=dtype, device=device)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    i64 = torch.int64
    return dict(
        org=V3(z(), z(), z()),
        d=V3(z() + 1.0, z(), z()),
        tp=V3(z(), z(), z()),
        pdf_prev=z(),
        eta_scale=z() + 1.0,
        rr_prev=z() + 1.0,
        cont=z() + 1.0,
        radius=z(),
        spread=z(),
        pixel=z(i64),
        sample=z(i64),
        bounce=z(INT),
        alive=z(),
        next_item=scalar(0, i64),
        total=scalar(total, i64),
        seed=int(seed) & _M32,
        rays=scalar(0.0, REAL),
        occ_sum=scalar(0.0, REAL),
        iters=scalar(0, i64),
        acc_x=z(n=n_pix), acc_y=z(n=n_pix), acc_z=z(n=n_pix),
    )


def render_soa_wavefront(scene: Scene, spp, seed=0, return_stats=False,
                         pool=None, k_iters=8, compact=True, pool_sort=False,
                         packet_wide=32, packet_dual=False, **cast):
    """Wavefront path render: fixed lane pool + sample regeneration.

    Produces the same estimate as the banded loop (identical RNG streams
    per (pixel, sample)); accumulation happens on the device in f32,
    drained into a host f64 buffer every 64 spp-equivalents. k_iters
    iterations run between host reads of the queue position; compact
    turns the tail compaction on; pool_sort=True morton-sorts the pool
    before every chunk of k_iters iterations (_pool_sort; BVH scenes
    only) and the extension casts then skip their own sort. packet_wide,
    packet_dual and **cast (two_phase, packet_sort, premerge, entry_k,
    packet, max_table_mb) choose the packet table and the walk (see
    scene_soa_from_aos). The
    iteration count and mean occupancy of the last render are left in
    render_soa_wavefront.last_iters and .last_occupancy.
    """
    static = scene.static
    w, h = static.width, static.height
    n_pix = w * h
    total = n_pix * spp
    if total >= 2 ** 32:
        # The work queue indexes (pixel, sample) items with a uint32
        # counter; beyond 2^32 it would silently wrap and drop samples.
        # render_soa routes such renders to the banded loop instead.
        raise ValueError(
            f"wavefront work queue: n_pix*spp = {total} >= 2^32; "
            "use render_soa (banded loop) for renders this large")
    sc = scene_soa_from_aos(scene, packet_wide, packet_dual, **cast)
    camera = scene.device.camera
    device = camera.sample_to_cam.device
    if sc.geom.packet is None and not scene.static.use_brute_force:
        trs.refuse_without_table(pool_sort=pool_sort)
    pool_sort = pool_sort and sc.geom.packet is not None

    pool = _pool_width(total, pool)
    st = _wavefront_state(n_pix, pool, total, seed, device)
    lane_q = LANE_QUANTUM
    # Device accumulation is f32 (scatter-add); to keep high-spp sums
    # from losing mantissa bits against a large accumulator, drain into
    # a host f64 buffer every ~64 started spp-equivalents. Safe mid-
    # flight: lanes scatter later contributions onto the zeroed f32
    # buffer and the final drain picks them up.
    host_acc = np.zeros((3, n_pix), np.float64)
    drain_step = n_pix * 64
    last_drain = 0

    def drain():
        packet_kernels.check_overflow()
        for c, key in enumerate(("acc_x", "acc_y", "acc_z")):
            host_acc[c] += st[key].cpu().numpy().astype(np.float64)
            st[key].zero_()

    cur_pool = pool
    while True:
        if pool_sort:
            st = _pool_sort(st, sc.geom.packet)
        for _ in range(k_iters):
            st = _wavefront_body(static, camera, sc, st, pool_sort)
        ni = int(st["next_item"])
        if ni >= total:
            n_alive = int((st["alive"] > 0).sum())
            if n_alive == 0:
                break
            # Drain tail: queue exhausted, surviving lanes at mixed
            # depths — compact them into the smallest pool bucket so
            # sort/cast/shade cost tracks the live count.
            if compact:
                tgt = _tail_bucket(n_alive, cur_pool, lane_q)
                if tgt is not None:
                    st = _shrink_pool_state(st, tgt)
                    cur_pool = tgt
        if ni - last_drain >= drain_step:
            drain()
            last_drain = ni
    drain()
    img = (host_acc / spp).T.reshape(h, w, 3).astype(np.float32)
    img = np.where(np.isfinite(img), img, 0.0)
    iters = int(st["iters"])
    render_soa_wavefront.last_iters = iters
    render_soa_wavefront.last_occupancy = float(st["occ_sum"]) / max(iters, 1)
    if return_stats:
        return img, float(st["rays"])
    return img


# Samples of banded path passes: replayed from a captured graph, or run
# eagerly; and the graphs captured (banded.sample_pass).
GRAPHS = profiling.counter_group("path_soa.graphs", {"captured": 0, "replayed": 0, "eager": 0})
# Pixel samples of banded path passes, replayed or eager: traced by the
# fused stages (path_fused.trace_paths_fused) or by trace_paths_soa.
FUSED = profiling.counter_group("path_soa.fused", {"fused": 0, "plain": 0})


def _add_sample(static, camera, sc, lanes, seed, sample, acc, rays):
    """One sample of trace_paths_soa added into the pass's sums in place:
    acc (3, n) f32, rows x, y, z, and rays, an f32 0-d tensor."""
    r, nr = trace_paths_soa(static, camera, sc, *lanes, seed, sample)
    for row, c in zip(acc, r):
        row.add_(c)
    rays.add_(nr.sum())


def _add_fused_sample(static, camera, sc, lanes, seed, sample, acc, rays):
    """_add_sample through path_fused.trace_paths_fused (the same bits)."""
    r, nr = path_fused.trace_paths_fused(static, camera, sc, *lanes, seed, sample)
    for row, c in zip(acc, r):
        row.add_(c)
    rays.add_(nr.sum())


def _soa_pass(static, camera, sc, xs, ys, ray_idx, seed, sample0, n_samples):
    """n_samples path samples summed in f32 for the whole ray batch;
    returns (radiance V3, total rays as an f32 0-d tensor):
    banded.sample_pass, replayed or eager, over _add_fused_sample where
    path_fused.supports holds and _add_sample elsewhere. The route's pixel
    samples are counted in FUSED here, as a replay runs no Python."""
    fused = path_fused.supports(static, xs.device)
    add, kernels = (_add_fused_sample, path_fused.LAUNCHES) if fused else (_add_sample, None)
    acc, rays, _ = banded.sample_pass(add, 3, GRAPHS, static, camera, sc, xs, ys, ray_idx, seed,
                                      sample0, n_samples, kernels)
    FUSED["fused" if fused else "plain"] += xs.shape[0] * n_samples
    return V3(*acc), rays


def render_soa(scene: Scene, spp=None, seed=0, return_stats=False, wavefront=None,
               pool_sort=False, packet_wide=32, packet_dual=False, start_sample=0,
               init_acc=None, on_chunk=None, mesh=None, **cast):
    """SoA render loop for the path integrator on the scene's device.
    Returns an (h, w, 3) float32 numpy image (and the traced ray count).

    wavefront (None, True or False), start_sample, init_acc, on_chunk
    and mesh choose the wavefront renderer or the banded loop
    (banded.route). pool_sort is the wavefront's (render_soa_wavefront).
    packet_wide (16 or 32) is the width of a BVH scene's packet table;
    packet_dual=True walks a 16-wide table with the dual kernel K4 in
    place of K3 (with width 32 it raises ValueError); **cast (two_phase,
    packet_sort, premerge, entry_k, packet, max_table_mb) are the walk's
    and the table's other switches (scene_soa_from_aos).

    The banded loop (banded.loop) resumes from start_sample and init_acc
    (the raw (3, n) float64 sample sums), calls on_chunk(acc, done) after
    every pass, and over a mesh (parallel/sharding.Mesh) pads each pass's
    rays to whole 128-lane groups per device (padded lanes trace pixel 0
    and count in the ray total, as the reference's do). Its pass replays
    a captured sample where banded.graphed() holds (_soa_pass).
    """
    static = scene.static
    w, h = static.width, static.height
    spp = spp if spp is not None else static.options.samples_per_pixel
    if banded.route(wavefront, static, w * h, spp, start_sample, init_acc, on_chunk, mesh):
        return render_soa_wavefront(scene, spp, seed=seed, return_stats=return_stats,
                                    pool_sort=pool_sort, packet_wide=packet_wide,
                                    packet_dual=packet_dual, **cast)
    seed = int(seed) & _M32

    def view(scene_d):
        return scene_d.device.camera, scene_soa_from_aos(scene_d, packet_wide, packet_dual,
                                                         **cast)

    def sample(v, xs, ys, ray_idx, done, k):
        return _soa_pass(static, *v, xs, ys, ray_idx, seed, done, k)

    def finish(acc, total_rays):
        img = banded.image(acc, spp, w, h)
        return (img, total_rays) if return_stats else img

    return banded.loop(scene, spp, view, sample, (3,), 1 << 26, start_sample, init_acc,
                       on_chunk, mesh, finish)
