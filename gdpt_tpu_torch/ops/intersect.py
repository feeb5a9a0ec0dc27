"""Intersection layer of the per-ray integrators: ray hit -> PathVertex.

Counterpart of gdpt_tpu/ops/intersect.py (reference:
src/intersection.cpp:7-64 and the shapes' compute_shading_info,
src/shapes/triangle_mesh.inl:77-169, src/shapes/sphere.inl:265-268),
lane-batched. Both shape kinds are shaded branch-free on every lane and
selected by primitive type, gated statically on whether the scene holds
that kind.

The casts are the port's kernels, through accel/traverse_soa.py: K1 (or
K3 / K4 on a BVH scene's packet table) for closest hits, K2 (or the
walk's any-hit mode) for `occluded`. The reference casts through its
per-ray walks of accel/traverse.py, which the port keeps as the
kernels' oracle (accel/traverse.py). A lane that is not live gets
tfar = tnear, so the kernel tests nothing for it, and only live lanes
count as rays.
"""

import math
from typing import NamedTuple

import torch

from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.accel.traverse import sphere_uv
from gdpt_tpu_torch.core import math as gm
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import INT, REAL
from gdpt_tpu_torch.core.math import lift as L
from gdpt_tpu_torch.core.math import where as W


class PathVertex(NamedTuple):
    position: torch.Tensor        # (N, 3)
    geom_normal: torch.Tensor     # (N, 3), flipped toward the shading normal
    frame: torch.Tensor           # (N, 3, 3) shading frame rows: x, y, n
    st: torch.Tensor              # (N, 2) surface parametrization
    uv: torch.Tensor              # (N, 2) texture uv
    uv_screen_size: torch.Tensor  # (N,) texture footprint
    mean_curvature: torch.Tensor  # (N,)
    ray_radius: torch.Tensor      # (N,) ray differential radius at the hit
    shape_id: torch.Tensor        # (N,) int
    prim_id: torch.Tensor         # (N,) int, global primitive id
    material_id: torch.Tensor     # (N,) int
    interior_medium_id: torch.Tensor
    exterior_medium_id: torch.Tensor
    valid: torch.Tensor           # (N,) bool


class Casts:
    """A scene's casts for the per-ray integrators: its traverse_soa view
    (triangle and sphere soups, the packet table of a BVH scene) and the
    running count of live rays cast, a 0-d int64 tensor on the device."""

    def __init__(self, geom: trs.GeomSoA):
        self.geom = geom
        self.rays = torch.zeros((), dtype=torch.int64, device=geom.tri_soup.device)


def _mesh_shading(scene, tri_id, bary, geom_normal):
    """Triangle shading info (reference: src/shapes/triangle_mesh.inl:77-169)."""
    idx = scene.tri_index[tri_id].long()
    p0, p1, p2 = (scene.vtx_pos[idx[:, k]] for k in range(3))
    has_uv = scene.tri_has_uvs[tri_id]
    dflt = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], dtype=REAL, device=p0.device)
    uv0, uv1, uv2 = (W(has_uv, scene.vtx_uv[idx[:, k]], dflt[k]) for k in range(3))
    b1, b2 = bary[:, 0], bary[:, 1]
    uv = L(1.0 - b1 - b2) * uv0 + L(b1) * uv1 + L(b2) * uv2

    # dp/duv via the duv/dst Jacobian inverse.
    duvds = uv2 - uv0
    duvdt = uv2 - uv1
    det = duvds[:, 0] * duvdt[:, 1] - duvdt[:, 0] * duvds[:, 1]
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-8, det, 1.0)
    dsdu = L(duvdt[:, 1] * inv_det)
    dtdu = L(-duvds[:, 1] * inv_det)
    dsdv = L(-duvdt[:, 0] * inv_det)
    dtdv = L(duvds[:, 0] * inv_det)
    dpds = p2 - p0
    dpdt = p2 - p1
    dpdu = dpds * dsdu + dpdt * dtdu
    dpdv = dpds * dsdv + dpdt * dtdv
    # Degenerate uv parametrization: any orthogonal basis.
    t_fallback, b_fallback = gm.coordinate_system(geom_normal)
    degen = torch.abs(det) <= 1e-8
    dpdu = W(degen, t_fallback, dpdu)
    dpdv = W(degen, b_fallback, dpdv)

    has_n = scene.tri_has_normals[tri_id]
    n0, n1, n2 = (scene.vtx_normal[idx[:, k]] for k in range(3))
    sn_interp = gm.normalize(L(1.0 - b1 - b2) * n0 + L(b1) * n1 + L(b2) * n2, eps=1e-20)
    shading_normal = W(has_n, sn_interp, geom_normal)

    tangent = gm.normalize(
        dpdu - shading_normal * L(gm.dot(shading_normal, dpdu)), eps=1e-20)
    bitangent = gm.normalize(gm.cross(shading_normal, tangent), eps=1e-20)

    # Mean curvature from dn/du, dn/dv (zero without vertex normals).
    dnds = n2 - n0
    dndt = n2 - n1
    dndu = dnds * dsdu + dndt * dtdu
    dndv = dnds * dsdv + dndt * dtdv
    mean_curvature = torch.where(
        has_n, 0.5 * (gm.dot(dndu, tangent) + gm.dot(dndv, bitangent)), 0.0)

    frame = gm.frame_from_tangent(tangent, bitangent, shading_normal)
    inv_uv_size = torch.maximum(gm.length(dpdu), gm.length(dpdv))
    return uv, frame, mean_curvature, inv_uv_size


def _sphere_shading(scene, sph_id, position):
    """Sphere shading info (reference: src/shapes/sphere.inl:265-268):
    spherical-coordinate tangents, mean curvature 1/r."""
    center = scene.geom.sph_center[sph_id]
    radius = scene.geom.sph_radius[sph_id]
    geom_normal = gm.normalize(position - center, eps=1e-20)
    u, v = sphere_uv(center, radius, position)
    theta_u = u * 2.0 * math.pi  # azimuth
    theta_v = v * math.pi        # elevation
    sin_u, cos_u = torch.sin(theta_u), torch.cos(theta_u)
    sin_v, cos_v = torch.sin(theta_v), torch.cos(theta_v)
    zero = torch.zeros_like(sin_u)
    dpdu = L(radius) * torch.stack([-sin_u, zero, cos_u], dim=-1) * L(sin_v)
    dpdv = L(radius) * torch.stack([cos_u * cos_v, -sin_v, sin_u * cos_v], dim=-1)
    tangent = gm.normalize(dpdu - geom_normal * L(gm.dot(geom_normal, dpdu)), eps=1e-20)
    bitangent = gm.normalize(gm.cross(geom_normal, tangent), eps=1e-20)
    frame = gm.frame_from_tangent(tangent, bitangent, geom_normal)
    inv_uv_size = 0.5 * (gm.length(dpdu) + gm.length(dpdv))
    st = torch.stack([u, v], dim=-1)
    return st, frame, geom_normal, 1.0 / radius, inv_uv_size


def vertex_from_hit(scene, static, org, d, hit: trs.HitSoA, ray_radius=0.0,
                    ray_spread=0.0) -> PathVertex:
    """Shading info of every lane's hit (t, prim_id, u, v each (N,))."""
    n_tris = static.n_tris
    position = org + L(hit.t) * d
    prim = torch.clamp_min(hit.prim_id, 0).long()
    n = prim.shape[0]
    dev = org.device

    st = torch.stack([hit.u, hit.v], dim=-1)
    uv = torch.zeros(n, 2, dtype=REAL, device=dev)
    frame = torch.eye(3, dtype=REAL, device=dev).expand(n, 3, 3)
    geom_normal = frame[:, 2]
    mean_curv = torch.zeros(n, dtype=REAL, device=dev)
    inv_uv_size = mean_curv + 1.0
    shape_id = torch.zeros(n, dtype=INT, device=dev)

    if n_tris:
        tri_id = torch.clamp(prim, 0, n_tris - 1)
        e1, e2 = scene.geom.tri_e1[tri_id], scene.geom.tri_e2[tri_id]
        geom_normal = gm.normalize(gm.cross(e1, e2), eps=1e-20)
        uv, frame, mean_curv, inv_uv_size = _mesh_shading(scene, tri_id, st, geom_normal)
        shape_id = scene.geom.tri_shape_id[tri_id]
    if static.n_spheres:
        sph_id = torch.clamp(prim - n_tris, 0, static.n_spheres - 1)
        st_s, frame_s, gn_s, mc_s, ius_s = _sphere_shading(scene, sph_id, position)
        sid_s = scene.geom.sph_shape_id[sph_id]
        if n_tris:
            sel = prim < n_tris
            uv = W(sel, uv, st_s)
            st = W(sel, st, st_s)
            frame = W(sel, frame, frame_s)
            geom_normal = W(sel, geom_normal, gn_s)
            mean_curv = torch.where(sel, mean_curv, mc_s)
            inv_uv_size = torch.where(sel, inv_uv_size, ius_s)
            shape_id = torch.where(sel, shape_id, sid_s)
        else:
            uv, st, frame = st_s, st_s, frame_s
            geom_normal, mean_curv, inv_uv_size, shape_id = gn_s, mc_s, ius_s, sid_s

    # Flip the geometric normal toward the shading normal
    # (reference: src/intersection.cpp:58-60).
    flip = gm.dot(geom_normal, frame[:, 2]) < 0
    geom_normal = W(flip, -geom_normal, geom_normal)

    new_radius = ray_radius + ray_spread * hit.t
    uv_screen = new_radius / torch.clamp_min(inv_uv_size, 1e-20)
    sid = shape_id.long()
    return PathVertex(
        position=position,
        geom_normal=geom_normal,
        frame=frame,
        st=st,
        uv=uv,
        uv_screen_size=uv_screen,
        mean_curvature=mean_curv,
        ray_radius=new_radius,
        shape_id=shape_id,
        prim_id=hit.prim_id,
        material_id=scene.shape_material_id[sid],
        interior_medium_id=scene.shape_interior_medium[sid],
        exterior_medium_id=scene.shape_exterior_medium[sid],
        valid=hit.prim_id >= 0,
    )


def _window(casts: Casts, org, tnear, tfar, live):
    """Per-lane tfar, cut to tnear on lanes that are not live; counts the
    live lanes as rays."""
    n = org.shape[0]
    tfar = torch.as_tensor(tfar, dtype=REAL, device=org.device).expand(n)
    if live is None:
        casts.rays += n
        return tfar.contiguous()
    casts.rays += live.sum()
    return torch.where(live, tfar, float(tnear)).contiguous()


def _v3(a):
    return soa.V3(a[:, 0].contiguous(), a[:, 1].contiguous(), a[:, 2].contiguous())


def cast(static, casts: Casts, org, d, tnear, tfar, live=None) -> trs.HitSoA:
    """Closest hits of the rays (org, d) within [tnear, tfar) through the
    port's kernels; a miss has prim -1 and t = tfar, as the reference's."""
    tf = _window(casts, org, tnear, tfar, live)
    hit, _ = trs.intersect_soa_gn(static, casts.geom, _v3(org), _v3(d), float(tnear), tf)
    return hit._replace(t=torch.where(hit.prim_id >= 0, hit.t, tf))


def intersect(scene, static, casts: Casts, org, d, tnear, tfar, live=None,
              ray_radius=0.0, ray_spread=0.0) -> PathVertex:
    """Closest hit + shading info, the rtcIntersect1 replacement."""
    hit = cast(static, casts, org, d, tnear, tfar, live)
    return vertex_from_hit(scene, static, org, d, hit, ray_radius, ray_spread)


def occluded(static, casts: Casts, org, d, tnear, tfar, live=None):
    """Any hit within [tnear, tfar) per lane (bool), the rtcOccluded1
    replacement."""
    tf = _window(casts, org, tnear, tfar, live)
    return trs.occluded_soa(static, casts.geom, _v3(org), _v3(d), float(tnear), tf) > 0
