"""The path integrator's pieces at one vertex, over SoA lanes.

Counterpart of the vertex, light and NEE half of
gdpt_tpu/integrators/path_soa.py: the scene's SoA view (SceneSoA, built
by path_soa.scene_soa_from_aos), a closest hit's vertex (shade_hit), its
emission, light and envmap sampling, NEE with power-2 MIS (nee_soa, or
nee_light, the shadow cast and nee_finish), the light pdf of a
BSDF-sampled hit and the camera rays; and the RNG's use-site counters.
integrators/path_soa.py's samples, gdpt_soa's, volpath_soa's and
path_fused's plain stages are built on them.
"""

import math
from typing import NamedTuple

import torch

from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import banded
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.ops import textures_soa as tsoa
from gdpt_tpu_torch.scene import textures as tex
from gdpt_tpu_torch.scene.build import LIGHT_ENVMAP, SHAPE_MESH, SHAPE_SPHERE


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
    # envmap tables (the build's dummies when the scene has none)
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
    # Dense (h*w, 3) level-0 copy of the env image ((1, 3) zeros when
    # the envmap is constant or absent): textures_soa.EnvmapSoA.img3.
    env_img3: torch.Tensor


def _env_view(static, sc: SceneSoA) -> tsoa.EnvmapSoA:
    """The envmap's EnvmapSoA, its kind, width and height as Python ints."""
    h = sc.env_pdf_marginals.shape[0]
    w = sc.env_pdf_rows.shape[1]
    return tsoa.EnvmapSoA(
        sc.env_to_world, sc.env_to_local, sc.env_scale,
        tex.TEX_IMAGE if static.envmap_is_image else tex.TEX_CONST,
        sc.env_value, sc.env_img_id,
        sc.env_cdf_rows, sc.env_pdf_rows,
        sc.env_cdf_marginals, sc.env_pdf_marginals,
        sc.env_alias_cut, sc.env_alias_idx, w, h,
        img3=sc.env_img3 if static.envmap_is_image else None,
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
    (light_id, pos, normal, pdf_area, is_env). For an envmap pick, pos is
    0, normal the negated sampled direction and pdf in solid angle."""
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
    is_env = torch.zeros_like(u0, dtype=torch.bool)
    if static.has_envmap:
        # Importance sampling by the envmap's table (uniform for constant
        # envmaps; reference: src/lights/envmap.inl:22-42).
        wdir, pdf_env = tsoa.envmap_sample_dir(_env_view(static, sc), u0, u1)
        is_env = soa.take(sc.light_kind, light_id) == LIGHT_ENVMAP
        pos = soa.where(is_env, V3(zero, zero, zero), pos)
        nrm = soa.where(is_env, -1.0 * wdir, nrm)
        pdf = torch.where(is_env, pdf_env, pdf)
    return light_id, pos, nrm, pdf, is_env


def envmap_pdf_for_dir(static, sc: SceneSoA, d: V3):
    """pdf of the envmap NEE sampler for direction d."""
    return tsoa.envmap_pdf_dir(_env_view(static, sc), d)


def primary_rays_soa(static, camera, xs, ys, u0, u1):
    """Batched camera rays with filter importance sampling
    (reference: src/camera.cpp:23-47)."""
    from gdpt_tpu_torch.scene import filters as gfilters

    n = xs.shape[0]
    wh = banded.film_size(static.width, static.height, xs.device)
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


class NeeTerms(NamedTuple):
    """NEE's light sample and terms up to its shadow ray (nee_light)."""
    dl: V3            # the shadow ray's direction
    tfar: torch.Tensor  # its tfar; -1 where no ray is needed
    need: torch.Tensor  # bool: the contribution can be nonzero
    g_geo: torch.Tensor
    p1: torch.Tensor
    p2_raw: torch.Tensor
    f_nee: V3
    l_emit: V3


def nee_light(static, sc: SceneSoA, v: VertexSoA, params, dir_view: V3,
              used, lu0, lu1, lw, lsw, active) -> NeeTerms:
    """NEE's light pick and point sample at vertex v and its terms up to
    the shadow ray: the first half of nee_soa."""
    zero = torch.zeros_like(lu0)
    zero3 = V3(zero, zero, zero)
    eps_shadow = static.shadow_epsilon
    light_id, p_l, n_l, pdf_pt, is_env = sample_light_point(
        static, sc, v.position, lu0, lu1, lw, lsw
    )
    to_l = p_l - v.position
    dist = soa.length(to_l)
    dir_area = to_l * (1.0 / torch.clamp_min(dist, 1e-20))
    dl = soa.where(is_env, -1.0 * n_l, dir_area)
    g_area = torch.clamp_min(-soa.dot(dl, n_l), 0.0) / torch.clamp_min(dist * dist, 1e-20)
    g_geo = torch.where(is_env, 1.0, g_area)
    p1 = soa.take(sc.light_pmf, light_id) * pdf_pt
    f_nee = msoa.eval_bsdf_soa(params, dir_view, dl, v.gn, v.frame, used)
    p2_raw = msoa.pdf_bsdf_soa(params, dir_view, dl, v.gn, v.frame, used)
    # Envmap taps at footprint 0 (a level-0 lookup), as the reference's.
    env_nee = (tsoa.envmap_emission_soa(_env_view(static, sc), sc.mat_tables.pool3, dl)
               if static.has_envmap else zero3)
    l_emit = soa.where(
        is_env,
        env_nee,
        soa.where(soa.dot(n_l, -1.0 * dl) > 0, soa.gather(sc.light_intensity, light_id),
                  zero3),
    )
    # Shadow rays only where the contribution can be nonzero; the other
    # lanes become dead rays (tfar < tnear). Estimator-identical: every
    # skipped lane's contribution is selected to exactly zero below.
    need = (active & (g_geo > 0) & (p1 > 0)
            & (soa.vmax(f_nee) > 0) & (soa.vmax(l_emit) > 0))
    tfar = torch.where(is_env, BIG, (1.0 - eps_shadow) * dist)
    tfar = torch.where(need, tfar, -1.0)
    return NeeTerms(dl, tfar, need, g_geo, p1, p2_raw, f_nee, l_emit)


def nee_finish(t: NeeTerms, unoccluded):
    """The masked contribution w1 * C1 / p1 and the traced-shadow-ray mask
    (f32) of NEE's terms t under the shadow ray's unoccluded (f32 0/1):
    the second half of nee_soa."""
    g = t.g_geo * unoccluded
    p2 = t.p2_raw * g
    ok = (g > 0) & (t.p1 > 0) & t.need
    w1 = torch.where(ok, t.p1 * t.p1 / torch.clamp_min(t.p1 * t.p1 + p2 * p2, 1e-30), 0.0)
    scale = g * w1 / torch.clamp_min(t.p1, 1e-30)
    # Select, don't multiply-by-zero: f_nee can be NaN on masked lanes.
    contrib = t.f_nee * t.l_emit * scale
    zero = torch.zeros_like(t.p1)
    return soa.where(ok, contrib, V3(zero, zero, zero)), t.need.to(REAL)


def nee_soa(static, sc: SceneSoA, v: VertexSoA, params, dir_view: V3,
            used, lu0, lu1, lw, lsw, active):
    """Batched NEE with power-2 MIS at vertex v; returns the masked
    contribution w1 * C1 / p1 and the traced-shadow-ray mask (f32)
    (reference: src/path_tracing.h:115-227)."""
    t = nee_light(static, sc, v, params, dir_view, used, lu0, lu1, lw, lsw, active)
    unoccluded = 1.0 - trs.occluded_soa(
        static, sc.geom, v.position, t.dl, static.shadow_epsilon, t.tfar)
    return nee_finish(t, unoccluded)


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
