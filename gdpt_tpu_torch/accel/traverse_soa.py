"""Batched (SoA) ray casting dispatch — replaces Embree's
rtcIntersect1/rtcOccluded1 (reference: src/intersection.cpp:32,83).

Counterpart of the brute-force half of gdpt_tpu/accel/traverse_soa.py.
All ray state lives in (N,) component tensors. Brute-force scenes (at
most 128 primitives) go to the K1/K2 wrappers of accel/brute_kernels.py:
the hand-written CUDA kernels for CUDA tensors, their plain PyTorch
versions for CPU tensors. BVH scenes are not ported yet and raise.
"""

from typing import NamedTuple

import torch

from gdpt_tpu_torch.accel import brute_kernels as bk
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.soa import V3


class GeomSoA(NamedTuple):
    """Component-transposed geometry view (built once per render), with
    the kernels' packed primitive soups."""

    tri_v0: V3
    tri_e1: V3
    tri_e2: V3
    sph_center: V3
    sph_radius: torch.Tensor
    tri_soup: torch.Tensor  # (9, T) v0.xyz e1.xyz e2.xyz
    sph_soup: torch.Tensor  # (4, S) center.xyz radius


def geom_soa_from_aos(geom) -> GeomSoA:
    n_tris = geom.tri_v0.shape[0]
    n_sph = geom.sph_center.shape[0]
    dev = geom.tri_v0.device
    z1 = torch.zeros(1, dtype=geom.tri_v0.dtype, device=dev)
    v0 = soa.from_rows(geom.tri_v0)
    e1 = soa.from_rows(geom.tri_e1)
    e2 = soa.from_rows(geom.tri_e2)
    center = soa.from_rows(geom.sph_center) if n_sph else V3(z1, z1.clone(), z1.clone())
    radius = geom.sph_radius if n_sph else torch.ones_like(z1)
    tri, sph = bk.pack_soups(v0, e1, e2, center, radius, n_tris, n_sph)
    return GeomSoA(v0, e1, e2, center, radius, tri, sph)


class HitSoA(NamedTuple):
    t: torch.Tensor
    prim_id: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor

    @property
    def valid(self):
        return self.prim_id >= 0


def intersect_brute_soa(static, g: GeomSoA, org: V3, d: V3, tnear):
    """Closest hit over every primitive (K1) and the unnormalized
    geometric normal of the hit primitive. Every ray is cast over
    [tnear, BIG): K1 takes no tfar, so callers mask lanes they retired."""
    t, prim, u, v, gx, gy, gz = bk.intersect_brute(
        g.tri_soup, g.sph_soup, static.n_tris, static.n_spheres,
        org.x, org.y, org.z, d.x, d.y, d.z, tnear)
    return HitSoA(t, prim, u, v), V3(gx, gy, gz)


def occluded_brute_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar):
    """Any hit within [tnear, tfar) per ray (K2); f32 0/1 mask."""
    return bk.occluded_brute(
        g.tri_soup, g.sph_soup, static.n_tris, static.n_spheres,
        org.x, org.y, org.z, d.x, d.y, d.z, tfar, tnear)


def _bvh_not_ported():
    return NotImplementedError(
        "BVH ray casting (scenes above 128 primitives) is not ported yet; "
        "see ROADMAP.md")


def intersect_soa_gn(static, g: GeomSoA, org: V3, d: V3, tnear, tfar=None):
    """(HitSoA, unnormalized geometric normal V3). `tfar` is accepted for
    the reference's signature; the brute-force cast ignores it."""
    if static.use_brute_force:
        return intersect_brute_soa(static, g, org, d, tnear)
    raise _bvh_not_ported()


def occluded_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar):
    if static.use_brute_force:
        return occluded_brute_soa(static, g, org, d, tnear, tfar)
    raise _bvh_not_ported()
