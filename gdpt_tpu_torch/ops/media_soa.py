"""Batched (SoA) participating-media ops on tensors.

Counterpart of gdpt_tpu/ops/media_soa.py (reference: src/medium.cpp,
src/volume.h, src/phase_functions/*.inl). Media are a static tuple, so
every coefficient lookup is a Python loop over media with a select per
lane.

The public functions take and return V3s, as the reference's do. The
volumetric integrator's inner loops call the row forms beside them
(`lookup3`, `majorant3`, `sigmas3`), which hold a vec3 as one (3, N)
tensor: the same operations on the same elements in the same order, in
a third of the launches. A grid volume is flattened once into (3, X*Y*Z)
component rows, so the eight trilinear taps are one gather; a density
and an albedo grid on one lattice are one volume of six rows.
"""

import math
from typing import NamedTuple, Optional

import torch

from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.scene import model as M


class VolumeSoA(NamedTuple):
    value: torch.Tensor     # (3,) constant value
    flat: torch.Tensor      # (C, X*Y*Z) the grid's component rows (C = 3)
    cells: torch.Tensor     # (3,) f32 (X-1, Y-1, Z-1): the grid's last index per axis
    p_min: torch.Tensor     # (3,)
    p_max: torch.Tensor
    max_data: torch.Tensor  # (3,)
    scale: torch.Tensor     # (), or (C, 1) per row


class MediumSoA(NamedTuple):
    sigma_a: torch.Tensor   # (3,)
    sigma_s: torch.Tensor
    albedo: VolumeSoA
    density: VolumeSoA
    phase_g: torch.Tensor   # ()
    # Density and albedo grids on one lattice (the same resolution and
    # bbox) as one volume of six rows, density's then albedo's, so that
    # both are looked up with one set of taps; None otherwise.
    both: Optional[VolumeSoA] = None


def volume_soa(vol) -> VolumeSoA:
    """VolumeArrays (scene/build.py) -> VolumeSoA."""
    zr, yr, xr = vol.grid.shape[:3]
    cells = torch.tensor([max(xr - 1, 0), max(yr - 1, 0), max(zr - 1, 0)], dtype=REAL,
                         device=vol.grid.device)
    return VolumeSoA(vol.value, vol.grid.reshape(-1, 3).T.contiguous(), cells,
                     vol.p_min, vol.p_max, vol.max_data, vol.scale)


def _joint(density: VolumeSoA, albedo: VolumeSoA, shared: bool):
    if not shared:
        return None
    return density._replace(
        flat=torch.cat([density.flat, albedo.flat]),
        scale=torch.cat([density.scale.expand(3), albedo.scale.expand(3)])[:, None])


def media_soa(media) -> tuple:
    """MediumArrays (scene/build.py) -> MediumSoA, once per render (it
    compares grid bounds on the host)."""
    out = []
    for m in media:
        density, albedo = volume_soa(m.density), volume_soa(m.albedo)
        shared = (m.density.grid.shape == m.albedo.grid.shape
                  and m.density.grid.shape[:3] != (1, 1, 1)
                  and bool(torch.equal(m.density.p_min, m.albedo.p_min))
                  and bool(torch.equal(m.density.p_max, m.albedo.p_max)))
        out.append(MediumSoA(m.sigma_a, m.sigma_s, albedo, density, m.phase_g,
                             _joint(density, albedo, shared)))
    return tuple(out)


def lookup3(vol: VolumeSoA, is_grid: bool, p, res=None):
    """Trilinear grid lookup at the (3, N) points p, zero outside the
    bbox (reference: src/volume.h:44-81); (C, N) for a grid of C rows.
    res: static (x, y, z) resolution (SceneStatic.media_grid_res)."""
    n = p.shape[1]
    if not is_grid:
        return vol.value[:, None].expand(3, n)
    rx, ry, rz = res
    ex = torch.clamp_min(vol.p_max - vol.p_min, 1e-20)
    pn = (p - vol.p_min[:, None]) / ex[:, None]
    inside = ((pn >= 0) & (pn <= 1)).all(dim=0)
    q = pn * vol.cells[:, None]
    # Cast, then clip, as the reference does: a point far outside (or a
    # NaN) lands on an edge cell, and its taps are selected away below.
    hi = vol.cells.to(torch.int64)[:, None]
    i0 = torch.minimum(torch.clamp_min(torch.floor(q).to(torch.int64), 0), hi)
    i1 = torch.minimum(i0 + 1, hi)
    f = q - i0.to(REAL)
    # Taps in the reference's order (z, y, x) with weights (wx * wy) * wz.
    w = torch.stack([1 - f, f])                            # (2, 3, N)
    wxy = w[None, :, 0] * w[:, None, 1]                    # (y, x, N)
    wts = (wxy[None] * w[:, None, None, 2]).reshape(8, n)  # (z, y, x) -> 8
    ii = torch.stack([i0, i1])                             # (2, 3, N)
    idx = (ii[:, None, None, 2] * ry + ii[None, :, None, 1]) * rx + ii[None, None, :, 0]
    taps = vol.flat[:, idx.reshape(-1)].reshape(-1, 8, n) * wts[None]
    out = taps[:, 0]
    for k in range(1, 8):
        out = out + taps[:, k]
    return torch.where(inside[None], out * vol.scale, 0.0)


def volume_lookup_soa(vol: VolumeSoA, is_grid: bool, p: V3, res=None) -> V3:
    """Trilinear grid lookup, zero outside the bbox (V3 form of lookup3)."""
    return soa.unstack(lookup3(vol, is_grid, soa.stack(p), res))


def hits_bbox3(vol: VolumeSoA, org, d, tfar=BIG):
    """Slab test of the (3, N) rays against the grid bbox
    (reference: src/volume.h:120-144); (N,) bool."""
    inv = 1.0 / torch.where(d == 0, 1e-20, d)
    t0 = (vol.p_min[:, None] - org) * inv
    t1 = (vol.p_max[:, None] - org) * inv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.clamp_min(torch.maximum(lo[0], torch.maximum(lo[1], lo[2])), 0.0)
    tf = torch.minimum(hi[0], torch.minimum(hi[1], hi[2]))
    tf = torch.minimum(tf, tfar) if isinstance(tfar, torch.Tensor) else torch.clamp_max(tf, tfar)
    return tn <= tf


def volume_ray_hits_bbox_soa(vol: VolumeSoA, org: V3, d: V3, tfar=BIG):
    return hits_bbox3(vol, soa.stack(org), soa.stack(d), tfar)


def _per_medium3(media, medium_id, fn):
    out = torch.zeros((3, medium_id.shape[0]), dtype=REAL, device=medium_id.device)
    for i, m in enumerate(media):
        out = torch.where(medium_id == i, fn(i, m), out)
    return out


def majorant3(media, static, medium_id, org, d, tfar=BIG):
    """Upper bound of sigma_t along the (3, N) rays (reference:
    src/medium.cpp:27); (3, N)."""
    def one(i, m: MediumSoA):
        if static.media_is_hetero[i]:
            hit = hits_bbox3(m.density, org, d, tfar)
            return torch.where(hit, m.density.max_data[:, None], 0.0)
        return (m.sigma_a + m.sigma_s)[:, None]

    return _per_medium3(media, medium_id, one)


def get_majorant_soa(media, static, medium_id, org: V3, d: V3, tfar=BIG) -> V3:
    return soa.unstack(majorant3(media, static, medium_id, soa.stack(org), soa.stack(d), tfar))


def sigmas3(media, static, medium_id, p):
    """(sigma_a, sigma_s) at the (3, N) points p, each (3, N): a grid
    medium's density times (1 - albedo) and times albedo, each grid
    looked up once."""
    def coeffs(i, m: MediumSoA):
        if static.media_is_hetero[i]:
            dres, ares = static.media_grid_res[i]
            if m.both is not None and static.media_albedo_is_grid[i]:
                density, albedo = lookup3(m.both, True, p, dres).split(3)
            else:
                density = lookup3(m.density, True, p, dres)
                albedo = lookup3(m.albedo, static.media_albedo_is_grid[i], p, ares)
            return density * (1.0 - albedo), density * albedo
        return m.sigma_a[:, None], m.sigma_s[:, None]

    zero = torch.zeros((3, p.shape[1]), dtype=REAL, device=p.device)
    sa, ss = zero, zero
    for i, m in enumerate(media):
        a, s = coeffs(i, m)
        here = medium_id == i
        sa, ss = torch.where(here, a, sa), torch.where(here, s, ss)
    return sa, ss


def get_sigma_s_soa(media, static, medium_id, p: V3) -> V3:
    return soa.unstack(sigmas3(media, static, medium_id, soa.stack(p))[1])


def get_sigma_a_soa(media, static, medium_id, p: V3) -> V3:
    return soa.unstack(sigmas3(media, static, medium_id, soa.stack(p))[0])


# --------------------------------------------------------------------------
# Phase functions (reference: src/phase_functions/*.inl)
# --------------------------------------------------------------------------


def _pow15(x):
    """x^1.5 in f32 as the reference's XLA CPU build evaluates it: its
    power is a near correctly rounded powf, which the f64 power rounded
    to f32 matches on 99.93% of lanes (torch's f32 pow on 98.2%, x *
    sqrt(x) on 75.6%)."""
    return torch.pow(x.double(), 1.5).to(REAL)


def _hg_value(g, cos_theta):
    return (1.0 / (4.0 * math.pi)) * (1.0 - g * g) / _pow15(
        torch.clamp_min(1.0 + g * g + 2.0 * g * cos_theta, 1e-8)
    )


def phase_eval_soa(media, static, medium_id, din: V3, dout: V3):
    """Scalar phase value; HG depends only on dot(din, dout)
    (reference: src/phase_functions/henyeygreenstein.inl:3-7)."""
    cos_t = soa.dot(din, dout)
    out = torch.zeros_like(cos_t)
    for i, m in enumerate(media):
        if static.media_phase_kinds[i] == M.PHASE_HG:
            val = _hg_value(m.phase_g, cos_t)
        else:
            val = torch.full_like(cos_t, 1.0 / (4.0 * math.pi))
        out = torch.where(medium_id == i, val, out)
    return out


def phase_pdf_soa(media, static, medium_id, din, dout):
    return phase_eval_soa(media, static, medium_id, din, dout)


def _uniform_sphere(u0, u1) -> V3:
    z = 1.0 - 2.0 * u0
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u1
    return V3(r * torch.cos(phi), r * torch.sin(phi), z)


def phase_sample_soa(media, static, medium_id, din: V3, u0, u1) -> V3:
    """Sample a scattered direction (reference:
    src/phase_functions/henyeygreenstein.inl:9-43 incl. the |g|<1e-3
    uniform-sphere fallback)."""
    out = _uniform_sphere(u0, u1)
    for i, m in enumerate(media):
        if static.media_phase_kinds[i] == M.PHASE_HG:
            g = m.phase_g
            small = torch.abs(g) < 1e-3
            safe_g = torch.where(small, 1e-3, g)
            tmp = (safe_g * safe_g - 1.0) / (2.0 * u0 * safe_g - (safe_g + 1.0))
            cos_e = torch.clamp(
                (tmp * tmp - (1.0 + safe_g * safe_g)) / (2.0 * safe_g), -1.0, 1.0
            )
            sin_e = torch.sqrt(torch.clamp_min(1.0 - cos_e * cos_e, 0.0))
            azim = 2.0 * math.pi * u1
            frame = soa.coordinate_system(din)
            hg = soa.to_world(
                frame, V3(sin_e * torch.cos(azim), sin_e * torch.sin(azim), cos_e)
            )
            val = soa.where(small, out, hg)
            out = soa.where(medium_id == i, val, out)
    return out


def update_medium_soa(int_med, ext_med, d: V3, gn: V3, medium_id):
    """Index-matched medium transition at a surface crossing
    (reference: src/vol_path_tracing.h:157-171)."""
    transition = int_med != ext_med
    going_out = soa.dot(d, gn) > 0
    new_id = torch.where(going_out, ext_med, int_med)
    return torch.where(transition, new_id, medium_id)
