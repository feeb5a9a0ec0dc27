"""Light sampling / pdf / emission of the per-ray integrators.

Counterpart of gdpt_tpu/ops/lights.py (reference: src/light.cpp +
src/lights/*.inl and the shape sampling ops they call:
src/shapes/sphere.inl:164-259, src/shapes/triangle_mesh.inl:24-75),
lane-batched: light and shape kinds are resolved with masks per lane,
gated statically on which kinds the scene holds. Vectors are (N, 3),
per-lane scalars and ids (N,).

A sampled light point is (position, normal). For environment maps the
"normal" stores the direction pointing outward from the light
(-direction_to_light) and the position is 0 (reference:
src/lights/envmap.inl:16-19).
"""

import math

import torch

from gdpt_tpu_torch.core import math as gm
from gdpt_tpu_torch.core.distributions import pdf_2d, sample_2d
from gdpt_tpu_torch.core.dtypes import INT, REAL
from gdpt_tpu_torch.core.math import lift as L
from gdpt_tpu_torch.core.math import where as W
from gdpt_tpu_torch.scene import textures as tex
from gdpt_tpu_torch.scene.build import LIGHT_AREA, LIGHT_ENVMAP, SHAPE_MESH, SHAPE_SPHERE

_PI = math.pi


def sample_light_id(scene, w):
    """Power-weighted light selection per lane (reference: src/scene.cpp:61,
    src/scene.h:86-89)."""
    n = scene.lights.pmf.shape[0]
    idx = torch.searchsorted(scene.lights.cdf, w, right=True) - 1
    return torch.clamp(idx, 0, n - 1).to(INT)


def light_pmf(scene, light_id):
    return scene.lights.pmf[light_id.long()]


def _sample_mesh_point(scene, light_id, uv, w):
    """Area-weighted triangle pick + uniform point
    (reference: src/shapes/triangle_mesh.inl:24-50)."""
    lid = light_id.long()
    cdf = scene.lights.tri_cdf[lid]
    n = cdf.shape[1] - 1
    local_tri = torch.clamp(torch.searchsorted(cdf, w[:, None], right=True)[:, 0] - 1, 0, n - 1)
    tri = scene.lights.tri_first[lid] + local_tri.to(INT)
    tri = torch.clamp(tri, 0, scene.tri_index.shape[0] - 1).long()
    idx = scene.tri_index[tri].long()
    v0, v1, v2 = (scene.vtx_pos[idx[:, k]] for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    a = torch.sqrt(torch.clamp(uv[:, 0], 0.0, 1.0))
    b1 = 1.0 - a
    b2 = a * uv[:, 1]
    gn = gm.normalize(gm.cross(e1, e2), eps=1e-20)
    # Flip the geometric normal toward the interpolated shading normal.
    has_n = scene.tri_has_normals[tri]
    n0, n1, n2 = (scene.vtx_normal[idx[:, k]] for k in range(3))
    sn = gm.normalize(L(1 - b1 - b2) * n0 + L(b1) * n1 + L(b2) * n2, eps=1e-20)
    flip = has_n & (gm.dot(gn, sn) < 0)
    gn = W(flip, -gn, gn)
    pos = v0 + e1 * L(b1) + e2 * L(b2)
    return pos, gn


def _sample_sphere_point(scene, shape_id, ref_point, uv):
    """PBRT cone sampling toward the sphere, uniform fallback inside
    (reference: src/shapes/sphere.inl:164-238)."""
    sph = scene.shape_prim_offset[shape_id.long()].long()
    center = scene.geom.sph_center[sph]
    r = scene.geom.sph_radius[sph]
    d2 = gm.distance_squared(ref_point, center)
    inside = d2 < r * r

    # Inside: uniform sphere.
    z = 1.0 - 2.0 * uv[:, 0]
    rr = gm.safe_sqrt(1.0 - z * z)
    phi = 2.0 * _PI * uv[:, 1]
    n_in = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi), z], dim=-1)
    p_in = center + L(r) * n_in

    # Outside: cone sampling.
    dir_to_center = gm.normalize(center - ref_point, eps=1e-20)
    frame = gm.make_frame(dir_to_center)
    sin2_max = r * r / torch.clamp_min(d2, 1e-20)
    cos_max = gm.safe_sqrt(1.0 - sin2_max)
    cos_e = (1.0 - uv[:, 0]) + uv[:, 0] * cos_max
    sin_e = gm.safe_sqrt(1.0 - cos_e * cos_e)
    azim = uv[:, 1] * 2.0 * _PI
    dc = torch.sqrt(torch.clamp_min(d2, 1e-20))
    ds = dc * cos_e - gm.safe_sqrt(r * r - dc * dc * sin_e * sin_e)
    cos_alpha = (dc * dc + r * r - ds * ds) / torch.clamp_min(2.0 * dc * r, 1e-20)
    sin_alpha = gm.safe_sqrt(1.0 - cos_alpha * cos_alpha)
    n_out = -gm.to_world(frame, torch.stack(
        [sin_alpha * torch.cos(azim), sin_alpha * torch.sin(azim), cos_alpha], dim=-1))
    p_out = center + L(r) * n_out
    return W(inside, p_in, p_out), W(inside, n_in, n_out)


def _envmap_dir_from_uv(scene, uv):
    """uv in [0,1]^2 -> world direction from the scene toward the envmap
    (reference: src/lights/envmap.inl:8-19; y-up convention)."""
    azimuth = uv[:, 0] * 2.0 * _PI
    elevation = uv[:, 1] * _PI
    local = torch.stack([
        torch.sin(azimuth) * torch.sin(elevation),
        torch.cos(elevation),
        -torch.cos(azimuth) * torch.sin(elevation),
    ], dim=-1)
    return gm.apply3(scene.envmap.to_world[:3, :3], local)


def envmap_uv_from_dir(scene, world_dir):
    """World direction (scene -> envmap) to uv (N, 2), plus sin(elevation)."""
    local = gm.apply3(scene.envmap.to_local[:3, :3], world_dir)
    u = torch.atan2(local[:, 0], -local[:, 2]) / (2.0 * _PI)
    u = torch.where(u < 0, u + 1.0, u)
    v = torch.arccos(torch.clamp(local[:, 1], -1.0, 1.0)) / _PI
    sin_elev = gm.safe_sqrt(1.0 - local[:, 1] * local[:, 1])
    return torch.stack([u, v], dim=-1), sin_elev


def sample_point_on_light(scene, static, light_id, ref_point, uv, w):
    """Returns (position, normal), each (N, 3). For envmaps,
    normal = -dir_to_light and position = 0 (reference convention)."""
    lid = light_id.long()
    pos = torch.zeros_like(ref_point)
    nrm = torch.zeros_like(ref_point)
    nrm[:, 2] = 1.0
    shape_id = torch.clamp_min(scene.lights.shape_id[lid], 0).long()
    is_area = scene.lights.kind[lid] == LIGHT_AREA
    if static.any_mesh_light:
        p_m, n_m = _sample_mesh_point(scene, light_id, uv, w)
        is_mesh = is_area & (scene.shape_kind[shape_id] == SHAPE_MESH)
        pos = W(is_mesh, p_m, pos)
        nrm = W(is_mesh, n_m, nrm)
    if static.any_sphere_light:
        p_s, n_s = _sample_sphere_point(scene, shape_id, ref_point, uv)
        is_sph = is_area & (scene.shape_kind[shape_id] == SHAPE_SPHERE)
        pos = W(is_sph, p_s, pos)
        nrm = W(is_sph, n_s, nrm)
    if static.has_envmap:
        env_uv = sample_2d(scene.envmap.dist, uv)
        wdir = _envmap_dir_from_uv(scene, env_uv)
        is_env = scene.lights.kind[lid] == LIGHT_ENVMAP
        pos = W(is_env, 0.0, pos)
        nrm = W(is_env, -wdir, nrm)
    return pos, nrm


def pdf_point_on_light(scene, static, light_id, point_pos, point_normal, ref_point):
    """Density of sample_point_on_light: area measure for surfaces, solid
    angle for envmaps (reference: src/light.cpp + the shape pdf ops)."""
    lid = light_id.long()
    pdf = torch.zeros_like(ref_point[:, 0])
    shape_id = torch.clamp_min(scene.lights.shape_id[lid], 0).long()
    is_area = scene.lights.kind[lid] == LIGHT_AREA
    if static.any_mesh_light:
        p_mesh = 1.0 / torch.clamp_min(scene.shape_area[shape_id], 1e-20)
        is_mesh = is_area & (scene.shape_kind[shape_id] == SHAPE_MESH)
        pdf = torch.where(is_mesh, p_mesh, pdf)
    if static.any_sphere_light:
        sph = scene.shape_prim_offset[shape_id].long()
        center = scene.geom.sph_center[sph]
        r = scene.geom.sph_radius[sph]
        d2 = gm.distance_squared(ref_point, center)
        inside = d2 < r * r
        p_uniform = 1.0 / torch.clamp_min(scene.shape_area[shape_id], 1e-20)
        sin2_max = r * r / torch.clamp_min(d2, 1e-20)
        cos_max = gm.safe_sqrt(1.0 - sin2_max)
        p_cone = 1.0 / torch.clamp_min(2.0 * _PI * (1.0 - cos_max), 1e-20)
        dvec = gm.normalize(point_pos - ref_point, eps=1e-20)
        p_area = p_cone * torch.abs(gm.dot(point_normal, dvec)) / torch.clamp_min(
            gm.distance_squared(ref_point, point_pos), 1e-20)
        p_sph = torch.where(inside, p_uniform, p_area)
        is_sph = is_area & (scene.shape_kind[shape_id] == SHAPE_SPHERE)
        pdf = torch.where(is_sph, p_sph, pdf)
    if static.has_envmap:
        env_uv, sin_elev = envmap_uv_from_dir(scene, -point_normal)
        p_env = torch.where(
            sin_elev > 0,
            pdf_2d(scene.envmap.dist, env_uv)
            / torch.clamp_min(2.0 * _PI * _PI * sin_elev, 1e-20),
            0.0,
        )
        is_env = scene.lights.kind[lid] == LIGHT_ENVMAP
        pdf = torch.where(is_env, p_env, pdf)
    return pdf


def emission_light(scene, static, light_id, view_dir, view_footprint, point_pos,
                   point_normal):
    """Emitted radiance toward view_dir (pointing away from the light)
    (reference: src/lights/diffuse_area_light.inl:16-21, envmap.inl:44-73)."""
    lid = light_id.long()
    is_area = scene.lights.kind[lid] == LIGHT_AREA
    area_val = W(gm.dot(point_normal, view_dir) > 0, scene.lights.intensity[lid], 0.0)
    out = W(is_area, area_val, 0.0)
    if static.has_envmap:
        env_val = envmap_emission(scene, -view_dir, view_footprint)
        is_env = scene.lights.kind[lid] == LIGHT_ENVMAP
        out = W(is_env, env_val, out)
    return out


def envmap_emission(scene, dir_to_env, spread):
    """Radiance arriving from the envmap along dir_to_env (scene -> env):
    always a level-0 bilinear lookup, as the reference's (see
    gdpt_tpu/ops/lights.py:envmap_emission for why)."""
    del spread
    uv, _ = envmap_uv_from_dir(scene, dir_to_env)
    zero = torch.zeros(uv.shape[0], dtype=torch.long, device=uv.device)
    val = tex.eval_texture(scene.pool3, tex.gather_desc(scene.envmap.tex, zero), uv,
                           torch.zeros(uv.shape[0], dtype=REAL, device=uv.device))
    return val * scene.envmap.scale


def emission_at_vertex(scene, static, vertex, view_dir):
    """Emission of the area light attached to each lane's hit shape
    (reference: src/intersection.cpp:87-98); zeros for other shapes."""
    light_id = scene.shape_light_id[vertex.shape_id.long()]
    val = emission_light(scene, static, torch.clamp_min(light_id, 0), view_dir,
                         vertex.uv_screen_size, vertex.position, vertex.geom_normal)
    return W(light_id >= 0, val, 0.0)
