"""Batched (SoA) surface path tracer on tensors.

Counterpart of gdpt_tpu/integrators/path_soa.py: NEE + power-2 MIS +
Russian roulette (reference: src/path_tracing.h:13-348) over (N,)
component tensors, with the same RNG streams and use-site counters, so
that at low spp the port is held against the reference pixel by pixel.

Ported: the banded loop (``trace_paths_soa``) and the wavefront
renderer (``render_soa_wavefront``, the default for BVH scenes) behind
``render_soa``, with Lambertian materials, constant/checkerboard
textures, mesh and sphere area lights; integrators/gdpt_soa.py builds
the gradient-domain render on the same pieces. Not yet: envmaps, image
textures, the other BSDFs, the pool-sorted wavefront, sharding and
resume (see ROADMAP.md).

Every tensor is made on the device the scene lives on.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from gdpt_tpu_torch.accel import packet_kernels
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import distributions as gdist
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL, asarray
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.scene.build import SHAPE_MESH, SHAPE_SPHERE, Scene, SceneMemo

HARD_BOUNCE_CAP = 64

# RNG use-site counters (stride 16 per bounce; each call yields 2 values).
_CTR_PIXEL = 0
_CTR_LIGHT_UV = 1
_CTR_LIGHT_W = 2
_CTR_BSDF_UV = 3
_CTR_BSDF_W = 4

_CTR_STRIDE = 16


class SceneSoA(NamedTuple):
    geom: trs.GeomSoA
    # Per-triangle flattened vertex attributes (one gather level).
    tri_n0: V3
    tri_n1: V3
    tri_n2: V3
    tri_uv0_u: torch.Tensor
    tri_uv0_v: torch.Tensor
    tri_uv1_u: torch.Tensor
    tri_uv1_v: torch.Tensor
    tri_uv2_u: torch.Tensor
    tri_uv2_v: torch.Tensor
    tri_shape_id: torch.Tensor
    tri_has_normals: torch.Tensor
    tri_has_uvs: torch.Tensor
    # Per-triangle material/light ids and ray-differential footprint
    # constants.
    tri_material_id: torch.Tensor
    tri_light_id: torch.Tensor
    tri_inv_uv: torch.Tensor
    tri_mean_curv: torch.Tensor
    sph_shape_id: torch.Tensor
    shape_kind: torch.Tensor
    shape_material_id: torch.Tensor
    shape_light_id: torch.Tensor
    shape_area: torch.Tensor
    shape_prim_offset: torch.Tensor
    shape_interior_medium: torch.Tensor
    shape_exterior_medium: torch.Tensor
    mat_tables: msoa.MaterialTablesSoA
    # lights
    light_kind: torch.Tensor
    light_shape_id: torch.Tensor
    light_intensity: V3
    light_tri_cdf: torch.Tensor
    light_tri_first: torch.Tensor
    light_pmf: torch.Tensor
    light_cdf: torch.Tensor
    # envmap tables: the reference's dummies (envmap scenes are not
    # ported and raise in scene_soa_from_aos)
    env_value: V3
    env_to_world: torch.Tensor
    env_to_local: torch.Tensor
    env_scale: torch.Tensor
    env_img_id: torch.Tensor
    env_cdf_rows: torch.Tensor
    env_pdf_rows: torch.Tensor
    env_cdf_marginals: torch.Tensor
    env_pdf_marginals: torch.Tensor
    env_alias_cut: torch.Tensor
    env_alias_idx: torch.Tensor
    env_img3: torch.Tensor


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


_SOA_MEMO = SceneMemo()


def scene_soa_from_aos(scene: Scene, wide=32, dual=False) -> SceneSoA:
    """The render's view of `scene`, built once per scene and table
    width: the host-side prep (packet table, alias tables, footprint
    constants) is pure in these and takes seconds on a large scene.
    wide: the packet table's supernode width, 16 or 32; dual: walk it
    with the dual kernel K4 (16-wide only) instead of K3. The dual view
    is the 16-wide view with its static flag set: the same tables."""
    if scene.static.has_envmap:
        raise NotImplementedError("envmap lights are not ported yet; see ROADMAP.md")
    if dual and wide != 16:
        raise ValueError(f"packet_dual=True needs packet_wide=16, got {wide!r}")
    sc = _SOA_MEMO.get(scene.device, wide, lambda: _scene_soa_from_aos(scene, wide))
    if dual and sc.geom.packet is not None:
        sc = sc._replace(geom=sc.geom._replace(dual=True))
    return sc


def _scene_soa_from_aos(scene: Scene, wide) -> SceneSoA:
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
    return SceneSoA(
        geom=trs.geom_soa_from_aos(dev.geom, wide=wide),
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
        env_img3=torch.zeros((1, 3), dtype=REAL, device=device),
    )


class VertexSoA(NamedTuple):
    position: V3
    gn: V3           # geometric normal, flipped toward shading normal
    frame: soa.Frame
    uv_u: torch.Tensor
    uv_v: torch.Tensor
    shape_id: torch.Tensor
    material_id: torch.Tensor
    light_id: torch.Tensor
    valid: torch.Tensor  # f32 mask (0/1)
    # Ray-differential footprint at the vertex: transferred ray radius,
    # uv-space screen footprint and surface mean curvature.
    radius: torch.Tensor
    fp: torch.Tensor
    mean_curv: torch.Tensor


def shade_hit(static, sc: SceneSoA, org: V3, d: V3, hit: trs.HitSoA,
              gn_raw: V3, ray_radius=None, ray_spread=None) -> VertexSoA:
    """Batched hit -> vertex (reference: src/intersection.cpp:7-64).
    gn_raw: the unnormalized geometric normal from the ray cast.
    ray_radius, ray_spread: per-lane ray differentials; without them the
    vertex carries a zero radius and footprint."""
    position = org + d * hit.t
    prim = torch.clamp_min(hit.prim_id, 0)
    zero = torch.zeros_like(hit.t)
    gn = V3(zero, zero, zero + 1.0)
    sn = gn
    shape_id = torch.zeros_like(prim)
    inv_uv = zero + 1.0
    mean_curv = zero
    # Barycentric fallback uv mapping ((0,0),(1,0),(1,1)) as in
    # reference: src/shapes/triangle_mesh.inl:84-90.
    uv_u = hit.u + hit.v
    uv_v = hit.v
    tri_mat_id = None
    tri_light_id = None
    if static.n_tris:
        tid = torch.clamp(prim, 0, static.n_tris - 1)
        gn_tri = soa.normalize(gn_raw)
        if static.any_mesh_normals:
            has_n = soa.take(sc.tri_has_normals, tid)
            b1 = hit.u
            b2 = hit.v
            b0 = 1.0 - b1 - b2
            n_interp = soa.normalize(
                soa.gather(sc.tri_n0, tid) * b0
                + soa.gather(sc.tri_n1, tid) * b1
                + soa.gather(sc.tri_n2, tid) * b2
            )
            sn_tri = soa.where(has_n, n_interp, gn_tri)
        else:
            sn_tri = gn_tri
        gn = gn_tri
        sn = sn_tri
        shape_id = soa.take(sc.tri_shape_id, tid)
        tri_mat_id = soa.take(sc.tri_material_id, tid)
        tri_light_id = soa.take(sc.tri_light_id, tid)
        inv_uv = soa.take(sc.tri_inv_uv, tid)
        mean_curv = soa.take(sc.tri_mean_curv, tid)
        if static.any_mesh_uvs:
            has_uv = soa.take(sc.tri_has_uvs, tid)
            b0u = 1.0 - hit.u - hit.v
            iu = (
                soa.take(sc.tri_uv0_u, tid) * b0u
                + soa.take(sc.tri_uv1_u, tid) * hit.u
                + soa.take(sc.tri_uv2_u, tid) * hit.v
            )
            iv = (
                soa.take(sc.tri_uv0_v, tid) * b0u
                + soa.take(sc.tri_uv1_v, tid) * hit.u
                + soa.take(sc.tri_uv2_v, tid) * hit.v
            )
            uv_u = torch.where(has_uv, iu, uv_u)
            uv_v = torch.where(has_uv, iv, uv_v)
    if static.n_spheres:
        sid = torch.clamp(prim - static.n_tris, 0, static.n_spheres - 1)
        gn_s = soa.normalize(gn_raw)
        is_sph = prim >= static.n_tris
        gn = soa.where(is_sph, gn_s, gn)
        sn = soa.where(is_sph, gn_s, sn)
        shape_id = torch.where(is_sph, soa.take(sc.sph_shape_id, sid), shape_id)
        # Spherical-coordinate uv (reference: src/shapes/sphere.inl:94-101).
        elev = torch.arccos(torch.clamp(gn_s.y, -1.0, 1.0))
        azim = torch.arctan2(gn_s.z, gn_s.x)
        su = azim / (2.0 * math.pi)
        su = torch.where(su < 0, su + 1.0, su)
        uv_u = torch.where(is_sph, su, uv_u)
        uv_v = torch.where(is_sph, elev / math.pi, uv_v)
        # Footprint constants (reference: src/shapes/sphere.inl:265-268).
        r_s = soa.take(sc.geom.sph_radius, sid)
        ius_s = 0.5 * (r_s * torch.sin(elev) + r_s)
        inv_uv = torch.where(is_sph, ius_s, inv_uv)
        mean_curv = torch.where(is_sph, 1.0 / torch.clamp_min(r_s, 1e-20),
                                mean_curv)
    frame = soa.coordinate_system(sn)
    flip = soa.dot(gn, sn) < 0
    gn = soa.where(flip, -gn, gn)
    if tri_mat_id is not None and not static.n_spheres:
        material_id, light_id = tri_mat_id, tri_light_id
    else:
        material_id = soa.take(sc.shape_material_id, shape_id)
        light_id = soa.take(sc.shape_light_id, shape_id)
    if ray_radius is None:
        radius_t, fp = zero, zero
    else:
        radius_t = ray_radius + ray_spread * hit.t
        fp = radius_t / torch.clamp_min(inv_uv, 1e-20)
    return VertexSoA(
        position=position,
        gn=gn,
        frame=frame,
        uv_u=uv_u,
        uv_v=uv_v,
        shape_id=shape_id,
        material_id=material_id,
        light_id=light_id,
        valid=(hit.prim_id >= 0).to(REAL),
        radius=radius_t,
        fp=fp,
        mean_curv=mean_curv,
    )


def emission(sc: SceneSoA, v: VertexSoA, view_dir: V3) -> V3:
    """Area-light emission toward view_dir (zero for non-lights)."""
    lid = torch.clamp_min(v.light_id, 0)
    intensity = soa.gather(sc.light_intensity, lid)
    facing = soa.dot(v.gn, view_dir) > 0
    ok = (v.light_id >= 0) & facing
    zero = torch.zeros_like(intensity.x)
    return soa.where(ok, intensity, V3(zero, zero, zero))


def _searchsorted_cdf(cdf_row, u):
    """Per-lane searchsorted over gathered cdf rows (N, K)."""
    return (cdf_row <= u[:, None]).sum(dim=1) - 1


def sample_light_point(static, sc: SceneSoA, ref: V3, u0, u1, uw, us):
    """Power-weighted light pick + point sample; returns
    (light_id, pos, normal, pdf_area)."""
    light_id = torch.clamp(
        torch.searchsorted(sc.light_cdf, uw, right=True) - 1,
        0, sc.light_pmf.shape[0] - 1,
    ).to(INT)
    shape_id = torch.clamp_min(soa.take(sc.light_shape_id, light_id), 0)
    zero = torch.zeros_like(u0)
    pos = V3(zero, zero, zero)
    nrm = V3(zero, zero, zero + 1.0)
    pdf = zero
    if static.any_mesh_light:
        cdf_rows = soa.take(sc.light_tri_cdf, light_id)
        local_tri = torch.clamp(
            _searchsorted_cdf(cdf_rows, us), 0, sc.light_tri_cdf.shape[1] - 2
        )
        tri = torch.clamp(
            soa.take(sc.light_tri_first, light_id) + local_tri.to(INT),
            0, max(static.n_tris - 1, 0),
        )
        v0 = soa.gather(sc.geom.tri_v0, tri)
        e1 = soa.gather(sc.geom.tri_e1, tri)
        e2 = soa.gather(sc.geom.tri_e2, tri)
        a = torch.sqrt(torch.clamp(u0, 0.0, 1.0))
        b1 = 1.0 - a
        b2 = a * u1
        gn = soa.normalize(soa.cross(e1, e2))
        has_n = soa.take(sc.tri_has_normals, tri)
        sn = soa.normalize(
            soa.gather(sc.tri_n0, tri) * (1 - b1 - b2)
            + soa.gather(sc.tri_n1, tri) * b1
            + soa.gather(sc.tri_n2, tri) * b2
        )
        gn = soa.where(has_n & (soa.dot(gn, sn) < 0), -gn, gn)
        p_mesh = v0 + e1 * b1 + e2 * b2
        is_mesh = soa.take(sc.shape_kind, shape_id) == SHAPE_MESH
        pos = soa.where(is_mesh, p_mesh, pos)
        nrm = soa.where(is_mesh, gn, nrm)
        pdf = torch.where(
            is_mesh, 1.0 / torch.clamp_min(soa.take(sc.shape_area, shape_id), 1e-20), pdf)
    if static.any_sphere_light:
        sph = soa.take(sc.shape_prim_offset, shape_id)
        center = soa.gather(sc.geom.sph_center, sph)
        r = soa.take(sc.geom.sph_radius, sph)
        to_c = center - ref
        d2 = soa.length_squared(to_c)
        inside = d2 < r * r
        # Inside: uniform sphere.
        z = 1.0 - 2.0 * u0
        rr = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = 2.0 * math.pi * u1
        n_in = V3(rr * torch.cos(phi), rr * torch.sin(phi), z)
        # Outside: cone sampling (reference: src/shapes/sphere.inl:164-238).
        dirc = soa.normalize(to_c)
        fr = soa.coordinate_system(dirc)
        sin2max = r * r / torch.clamp_min(d2, 1e-20)
        cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2max, 0.0))
        cos_e = (1.0 - u0) + u0 * cos_max
        sin_e = torch.sqrt(torch.clamp_min(1.0 - cos_e * cos_e, 0.0))
        azim = u1 * 2.0 * math.pi
        dc = torch.sqrt(torch.clamp_min(d2, 1e-20))
        ds = dc * cos_e - torch.sqrt(torch.clamp_min(r * r - dc * dc * sin_e * sin_e, 0.0))
        cos_a = (dc * dc + r * r - ds * ds) / torch.clamp_min(2.0 * dc * r, 1e-20)
        sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
        n_out = -1.0 * soa.to_world(
            fr, V3(sin_a * torch.cos(azim), sin_a * torch.sin(azim), cos_a)
        )
        n_s = soa.where(inside, n_in, n_out)
        p_s = center + n_s * r
        pdf_uniform = 1.0 / torch.clamp_min(soa.take(sc.shape_area, shape_id), 1e-20)
        pdf_cone_sa = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cos_max), 1e-20)
        dl = soa.normalize(p_s - ref)
        pdf_cone = pdf_cone_sa * torch.abs(soa.dot(n_s, dl)) / torch.clamp_min(
            soa.length_squared(p_s - ref), 1e-20
        )
        pdf_s = torch.where(inside, pdf_uniform, pdf_cone)
        is_sph = soa.take(sc.shape_kind, shape_id) == SHAPE_SPHERE
        pos = soa.where(is_sph, p_s, pos)
        nrm = soa.where(is_sph, n_s, nrm)
        pdf = torch.where(is_sph, pdf_s, pdf)
    return light_id, pos, nrm, pdf


def primary_rays_soa(static, camera, xs, ys, u0, u1):
    """Batched camera rays with filter importance sampling
    (reference: src/camera.cpp:23-47)."""
    from gdpt_tpu_torch.scene import filters as gfilters

    w, h = static.width, static.height
    n = xs.shape[0]
    wh = torch.tensor([w, h], dtype=REAL, device=xs.device)
    pix = torch.stack([xs + u0, ys + u1], dim=-1) / wh
    pixel = pix * wh
    frac = pixel - torch.floor(pixel)
    offset = gfilters.sample_filter(static.filter_kind, static.filter_param, frac)
    remapped = (torch.floor(pixel) + 0.5 + offset) / wh
    m = camera.sample_to_cam
    px, py = remapped[:, 0], remapped[:, 1]
    ptx = m[0, 0] * px + m[0, 1] * py + m[0, 3]
    pty = m[1, 0] * px + m[1, 1] * py + m[1, 3]
    ptz = m[2, 0] * px + m[2, 1] * py + m[2, 3]
    ptw = m[3, 0] * px + m[3, 1] * py + m[3, 3]
    pt = V3(ptx / ptw, pty / ptw, ptz / ptw)
    c2w = camera.cam_to_world
    d_cam = soa.normalize(pt)
    d = soa.normalize(
        V3(
            c2w[0, 0] * d_cam.x + c2w[0, 1] * d_cam.y + c2w[0, 2] * d_cam.z,
            c2w[1, 0] * d_cam.x + c2w[1, 1] * d_cam.y + c2w[1, 2] * d_cam.z,
            c2w[2, 0] * d_cam.x + c2w[2, 1] * d_cam.y + c2w[2, 2] * d_cam.z,
        )
    )
    org = V3(*(c2w[i, 3].expand(n).contiguous() for i in range(3)))
    return org, d


def nee_soa(static, sc: SceneSoA, v: VertexSoA, params, dir_view: V3,
            used, lu0, lu1, lw, lsw, active):
    """Batched NEE with power-2 MIS at vertex v; returns the masked
    contribution w1 * C1 / p1 and the traced-shadow-ray mask (f32)
    (reference: src/path_tracing.h:115-227)."""
    zero = torch.zeros_like(lu0)
    zero3 = V3(zero, zero, zero)
    eps_shadow = static.shadow_epsilon
    light_id, p_l, n_l, pdf_pt = sample_light_point(
        static, sc, v.position, lu0, lu1, lw, lsw
    )
    to_l = p_l - v.position
    dist = soa.length(to_l)
    dl = to_l * (1.0 / torch.clamp_min(dist, 1e-20))
    g_geo = torch.clamp_min(-soa.dot(dl, n_l), 0.0) / torch.clamp_min(dist * dist, 1e-20)
    p1 = soa.take(sc.light_pmf, light_id) * pdf_pt
    f_nee = msoa.eval_bsdf_soa(params, dir_view, dl, v.gn, v.frame, used)
    p2_raw = msoa.pdf_bsdf_soa(params, dir_view, dl, v.gn, v.frame, used)
    l_emit = soa.where(
        soa.dot(n_l, -1.0 * dl) > 0,
        soa.gather(sc.light_intensity, light_id),
        zero3,
    )
    # Shadow rays only where the contribution can be nonzero; the other
    # lanes become dead rays (tfar < tnear). Estimator-identical: every
    # skipped lane's contribution is selected to exactly zero below.
    need = (active & (g_geo > 0) & (p1 > 0)
            & (soa.vmax(f_nee) > 0) & (soa.vmax(l_emit) > 0))
    tfar = torch.where(need, (1.0 - eps_shadow) * dist, -1.0)
    unoccluded = 1.0 - trs.occluded_soa(
        static, sc.geom, v.position, dl, eps_shadow, tfar)
    g = g_geo * unoccluded
    p2 = p2_raw * g
    ok = (g > 0) & (p1 > 0) & need
    w1 = torch.where(ok, p1 * p1 / torch.clamp_min(p1 * p1 + p2 * p2, 1e-30), 0.0)
    scale = g * w1 / torch.clamp_min(p1, 1e-30)
    # Select, don't multiply-by-zero: f_nee can be NaN on masked lanes.
    contrib = f_nee * l_emit * scale
    return soa.where(ok, contrib, zero3), need.to(REAL)


def hit_light_pdf_soa(static, sc: SceneSoA, ref_pos: V3, nxt: VertexSoA,
                      d_out: V3, dist2):
    """p1 = pmf * pdf_point_on_light for a BSDF-sampled hit of an area
    light (area measure; reference: src/path_tracing.h:291-325)."""
    lid = torch.clamp_min(nxt.light_id, 0)
    lshape = torch.clamp_min(soa.take(sc.light_shape_id, lid), 0)
    pdf_mesh = 1.0 / torch.clamp_min(soa.take(sc.shape_area, lshape), 1e-20)
    if static.any_sphere_light:
        sph = soa.take(sc.shape_prim_offset, lshape)
        center = soa.gather(sc.geom.sph_center, sph)
        r = soa.take(sc.geom.sph_radius, sph)
        d2c = soa.length_squared(ref_pos - center)
        inside = d2c < r * r
        sin2max = r * r / torch.clamp_min(d2c, 1e-20)
        cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2max, 0.0))
        pdf_cone_sa = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cos_max), 1e-20)
        pdf_sph = torch.where(
            inside,
            pdf_mesh,
            pdf_cone_sa * torch.abs(soa.dot(nxt.gn, d_out)) / torch.clamp_min(dist2, 1e-20),
        )
        pdf_pt2 = torch.where(
            soa.take(sc.shape_kind, lshape) == SHAPE_SPHERE, pdf_sph, pdf_mesh
        )
    else:
        pdf_pt2 = pdf_mesh
    return soa.take(sc.light_pmf, lid) * pdf_pt2


def trace_paths_soa(static, camera, sc: SceneSoA, xs, ys, ray_idx, seed, sample0):
    """One sample for every ray in the batch; returns (radiance V3, rays
    per lane). seed and sample0 are Python ints (uint32 values)."""
    used = static.used_material_kinds
    w, h = static.width, static.height
    n = xs.shape[0]
    max_depth = static.options.max_depth
    n_iters = HARD_BOUNCE_CAP if max_depth < 0 else max(max_depth - 1, 0)

    def uni2(bounce, ctr):
        return soa.uniform2(seed, ray_idx, bounce * _CTR_STRIDE + ctr, sample0)

    # Primary ray with filter importance sampling.
    u0, u1 = uni2(0, _CTR_PIXEL)
    org, d = primary_rays_soa(static, camera, xs, ys, u0, u1)

    # Ray differentials (reference: src/ray.h:36-38).
    zero = torch.zeros(n, dtype=REAL, device=xs.device)
    spread = torch.full((n,), 0.25 / max(w, h), dtype=REAL, device=xs.device)
    hit, gn_raw = trs.intersect_soa_gn(static, sc.geom, org, d, 0.0, BIG)
    vertex = shade_hit(static, sc, org, d, hit, gn_raw,
                       ray_radius=zero, ray_spread=spread)
    rays = torch.ones(n, dtype=REAL, device=xs.device)
    zero3 = V3(zero, zero, zero)
    radiance = soa.where(vertex.valid > 0, emission(sc, vertex, -d), zero3)
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
        params = msoa.gather_params_soa(
            sc.mat_tables, used, v.material_id, v.uv_u, v.uv_v,
            static.spec_image_slots, float_tex_slots=static.float_tex_slots,
        )

        # ---- NEE (reference: src/path_tracing.h:115-227) ----
        if static.n_lights > 0:
            lu0, lu1 = uni2(b, _CTR_LIGHT_UV)
            lw, lsw = uni2(b, _CTR_LIGHT_W)
            nee, shadow_mask = nee_soa(static, sc, v, params, dir_view,
                                       used, lu0, lu1, lw, lsw, active)
            radiance = radiance + throughput * nee
            rays = rays + shadow_mask

        # ---- BSDF sampling (reference: src/path_tracing.h:232-345) ----
        bu0, bu1 = uni2(b, _CTR_BSDF_UV)
        w_lobe, u_rr = uni2(b, _CTR_BSDF_W)
        samp = msoa.sample_bsdf_soa(params, dir_view, v.gn, v.frame, bu0, bu1,
                                    w_lobe, used)
        d_out = samp.dir_out
        f_b = msoa.eval_bsdf_soa(params, dir_view, d_out, v.gn, v.frame, used)
        pdf_b = msoa.pdf_bsdf_soa(params, dir_view, d_out, v.gn, v.frame, used)
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

        # Retired lanes are dead rays (tfar < tnear) to the BVH walk; K1
        # casts every lane, and their hits are masked below.
        nxt_hit, nxt_gn = trs.intersect_soa_gn(
            static, sc.geom, v.position, d_out, eps_isect,
            torch.where(active, BIG, -1.0))
        nxt = shade_hit(static, sc, v.position, d_out, nxt_hit, nxt_gn,
                        ray_radius=v.radius, ray_spread=new_spread)
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


def _wavefront_body(static, camera, sc, st):
    """One wavefront iteration: regenerate dead lanes with the next
    (pixel, sample) work items, trace pending rays, collect emitter
    radiance with carried-pdf MIS, NEE, sample the next bounce, RR.

    Estimator-identical to trace_paths_soa (same RNG streams/counters per
    (pixel, sample), same MIS/RR math) but runs a fixed-size lane pool at
    ~full occupancy instead of letting the whole image drain to its
    slowest path. This is the wavefront analog of the reference's
    per-thread serial loop (src/render.cpp:82-117) — sample regeneration
    replaces tile scheduling.

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
    hit, gn_raw = trs.intersect_soa_gn(static, sc.geom, org, d, tnear, tfar)
    v = shade_hit(static, sc, org, d, hit, gn_raw,
                  ray_radius=radius, ray_spread=spread)
    rays = st["rays"] + alive.to(REAL).sum()
    v_ok = (v.valid > 0) & alive
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

    # --- NEE + next bounce at the hit vertex ---
    b = bounce + 1

    def ctr(c):
        return b.to(torch.int64) * _CTR_STRIDE + c

    ext = v_ok & cont & (bounce < n_iters)
    params = msoa.gather_params_soa(
        sc.mat_tables, used, v.material_id, v.uv_u, v.uv_v,
        static.spec_image_slots, float_tex_slots=static.float_tex_slots)
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
                         pool=None, k_iters=8, compact=True,
                         packet_wide=32, packet_dual=False):
    """Wavefront path render: fixed lane pool + sample regeneration.

    Produces the same estimate as the banded loop (identical RNG streams
    per (pixel, sample)); accumulation happens on the device in f32,
    drained into a host f64 buffer every 64 spp-equivalents. k_iters
    iterations run between host reads of the queue position; compact
    turns the tail compaction on. packet_wide and packet_dual choose
    the packet table's width and the walk (see scene_soa_from_aos). The
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
    sc = scene_soa_from_aos(scene, packet_wide, packet_dual)
    camera = scene.device.camera
    device = camera.sample_to_cam.device

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
        for _ in range(k_iters):
            st = _wavefront_body(static, camera, sc, st)
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


def _soa_pass(static, camera, sc, xs, ys, ray_idx, seed, sample0, n_samples):
    """n_samples samples summed in f32 for the whole ray batch; returns
    (radiance V3, total rays as an f32 0-d tensor)."""
    acc = V3(*(torch.zeros_like(xs),) * 3)
    rays = torch.zeros((), dtype=REAL, device=xs.device)
    for i in range(n_samples):
        r, nr = trace_paths_soa(static, camera, sc, xs, ys, ray_idx, seed,
                                sample0 + i)
        acc = V3(acc.x + r.x, acc.y + r.y, acc.z + r.z)
        rays = rays + nr.sum()
    return acc, rays


def render_soa(scene: Scene, spp=None, seed=0, return_stats=False, wavefront=None,
               packet_wide=32, packet_dual=False):
    """SoA render loop for the path integrator on the scene's device.
    Returns an (h, w, 3) float32 numpy image (and the traced ray count).

    wavefront=None takes the wavefront renderer for BVH scenes whose
    work queue fits (n_pix * spp < 2^32) and the banded loop otherwise;
    True or False picks one. The banded loop runs passes of samples, each
    summed in f32 on the device and accumulated in float64 on the host.
    packet_wide (16 or 32) is the width of a BVH scene's packet table;
    packet_dual=True walks a 16-wide table with the dual kernel K4 in
    place of K3 (with width 32 it raises ValueError).
    """
    static = scene.static
    w, h = static.width, static.height
    spp = spp if spp is not None else static.options.samples_per_pixel
    n = w * h
    if wavefront is None:
        # BVH scenes: the wavefront pool keeps every dispatch at ~full
        # occupancy (sample regeneration); the banded loop pays
        # full-batch sort/gather/material cost per bounce even when most
        # lanes are dead.
        wavefront = not static.use_brute_force and n * spp < 2 ** 32
    if wavefront:
        return render_soa_wavefront(scene, spp, seed=seed, return_stats=return_stats,
                                    packet_wide=packet_wide, packet_dual=packet_dual)
    sc = scene_soa_from_aos(scene, packet_wide, packet_dual)
    camera = scene.device.camera
    device = camera.sample_to_cam.device
    ys, xs = np.mgrid[0:h, 0:w]
    xs_d = torch.as_tensor(xs.ravel(), dtype=REAL, device=device)
    ys_d = torch.as_tensor(ys.ravel(), dtype=REAL, device=device)
    ray_idx = torch.arange(n, dtype=torch.int64, device=device)

    # Brute scenes are throughput-bound: big sample batches per pass.
    # BVH scenes take one sample per pass, as the reference does.
    batch = max(1, (1 << 26) // n) if static.use_brute_force else 1
    acc = np.zeros((3, n), np.float64)
    total_rays = 0.0
    done = 0
    while done < spp:
        k = min(batch, spp - done)
        out, nrays = _soa_pass(static, camera, sc, xs_d, ys_d, ray_idx,
                               int(seed) & 0xFFFFFFFF, done, k)
        packet_kernels.check_overflow()
        for c in range(3):
            acc[c] += out[c].cpu().numpy().astype(np.float64)
        total_rays += float(nrays)
        done += k
    img = (acc / spp).T.reshape(h, w, 3).astype(np.float32)
    img = np.where(np.isfinite(img), img, 0.0)
    if return_stats:
        return img, total_rays
    return img
