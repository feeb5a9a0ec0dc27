"""Participating media of the per-ray integrators: volumes, medium
coefficients, phase functions.

Counterpart of gdpt_tpu/ops/media.py (reference: src/medium.h/.cpp,
src/media/*.inl, src/volume.h, src/phase_function.h and
src/phase_functions/*.inl), lane-batched. The current medium is a
per-lane id; the scene's media are a static tuple, so each op evaluates
every medium on all lanes and selects by id (a masked select, the
reference's _per_medium), and each medium's grid keeps its own shape.
Vectors and coefficients are (N, 3), phase values (N,).
"""

import math

import torch

from gdpt_tpu_torch.core import math as gm
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.math import where as W
from gdpt_tpu_torch.scene import model as M

_INV_4PI = 1.0 / (4.0 * math.pi)

# --------------------------------------------------------------------------
# Volumes
# --------------------------------------------------------------------------


def volume_lookup(vol, is_grid: bool, p):
    """Trilinear grid lookup per lane, zero outside the bbox
    (reference: src/volume.h:44-81); a constant volume's value otherwise."""
    if not is_grid:
        return vol.value.expand(p.shape)
    res_z, res_y, res_x = vol.grid.shape[0], vol.grid.shape[1], vol.grid.shape[2]
    pn = (p - vol.p_min) / torch.clamp_min(vol.p_max - vol.p_min, 1e-20)
    inside = ((pn >= 0.0) & (pn <= 1.0)).all(dim=-1)
    hi = torch.tensor([res_x - 1, res_y - 1, res_z - 1], dtype=INT, device=p.device)
    q = pn * torch.clamp_min(hi.to(REAL), 0.0)
    q0 = torch.minimum(torch.clamp_min(torch.floor(q).to(INT), 0), hi)
    q1 = torch.minimum(q0 + 1, hi)
    f = q - q0.to(REAL)
    x0, y0, z0 = (q0[:, k].long() for k in range(3))
    x1, y1, z1 = (q1[:, k].long() for k in range(3))
    fx, fy, fz = (f[:, k:k + 1] for k in range(3))
    g = vol.grid
    out = vol.scale * (
        g[z0, y0, x0] * ((1 - fx) * (1 - fy) * (1 - fz))
        + g[z0, y0, x1] * (fx * (1 - fy) * (1 - fz))
        + g[z0, y1, x0] * ((1 - fx) * fy * (1 - fz))
        + g[z0, y1, x1] * (fx * fy * (1 - fz))
        + g[z1, y0, x0] * ((1 - fx) * (1 - fy) * fz)
        + g[z1, y0, x1] * (fx * (1 - fy) * fz)
        + g[z1, y1, x0] * ((1 - fx) * fy * fz)
        + g[z1, y1, x1] * (fx * fy * fz)
    )
    return W(inside, out, 0.0)


def volume_ray_hits_bbox(vol, org, d, tfar):
    """Slab test against the grid bbox per lane (reference: src/volume.h:120-144)."""
    inv = 1.0 / torch.where(d == 0, 1e-20, d)
    t0s = (vol.p_min - org) * inv
    t1s = (vol.p_max - org) * inv
    tlo = torch.minimum(t0s, t1s)
    thi = torch.maximum(t0s, t1s)
    t0 = torch.clamp_min(tlo.amax(dim=-1), 0.0)
    t1 = torch.clamp_max(thi.amin(dim=-1), tfar)
    return t0 <= t1


# --------------------------------------------------------------------------
# Medium coefficients
# --------------------------------------------------------------------------


def _per_medium(scene, medium_id, like, fn):
    """fn(i, medium) for each medium, selected per lane by id; zeros for
    medium_id < 0 (vacuum)."""
    out = torch.zeros_like(like)
    for i, m in enumerate(scene.media):
        out = W(medium_id == i, fn(i, m), out)
    return out


def get_majorant(scene, static, medium_id, org, d, tfar=BIG):
    """Upper bound of sigma_t along the ray (reference: src/medium.cpp:27,
    media/homogeneous.inl, media/heterogeneous.inl:3-9)."""

    def one(i, m):
        if static.media_is_hetero[i]:
            hit = volume_ray_hits_bbox(m.density, org, d, tfar)
            return W(hit, m.density.max_data.expand(org.shape), 0.0)
        return m.sigma_a + m.sigma_s

    return _per_medium(scene, medium_id, org, one)


def get_sigma_s(scene, static, medium_id, p):
    def one(i, m):
        if static.media_is_hetero[i]:
            density = volume_lookup(m.density, True, p)
            albedo = volume_lookup(m.albedo, static.media_albedo_is_grid[i], p)
            return density * albedo
        return m.sigma_s

    return _per_medium(scene, medium_id, p, one)


def get_sigma_a(scene, static, medium_id, p):
    def one(i, m):
        if static.media_is_hetero[i]:
            density = volume_lookup(m.density, True, p)
            albedo = volume_lookup(m.albedo, static.media_albedo_is_grid[i], p)
            return density * (1.0 - albedo)
        return m.sigma_a

    return _per_medium(scene, medium_id, p, one)


# --------------------------------------------------------------------------
# Phase functions (reference: src/phase_functions/*.inl)
# --------------------------------------------------------------------------


def _hg_value(g, cos_theta):
    return _INV_4PI * (1.0 - g * g) / torch.pow(
        torch.clamp_min(1.0 + g * g + 2.0 * g * cos_theta, 1e-8), 1.5)


def phase_eval(scene, static, medium_id, din, dout):
    """Phase value per lane (achromatic). HG depends only on dot(din,
    dout), the reference's argument convention (reference:
    src/phase_functions/henyeygreenstein.inl:3-7)."""
    cos_t = gm.dot(din, dout)
    out = torch.zeros_like(cos_t)
    for i, m in enumerate(scene.media):
        if static.media_phase_kinds[i] == M.PHASE_HG:
            val = _hg_value(m.phase_g, cos_t)
        else:
            val = _INV_4PI
        out = torch.where(medium_id == i, val, out)
    return out


def phase_pdf(scene, static, medium_id, din, dout):
    return phase_eval(scene, static, medium_id, din, dout)


def phase_sample(scene, static, medium_id, din, uv):
    """Sample scattered directions (reference:
    src/phase_functions/henyeygreenstein.inl:9-43, with the |g| < 1e-3
    uniform-sphere fallback)."""
    uniform = gm.sample_uniform_sphere(uv)
    out = uniform
    for i, m in enumerate(scene.media):
        if static.media_phase_kinds[i] == M.PHASE_HG:
            g = m.phase_g
            safe_g = torch.where(torch.abs(g) < 1e-3, 1e-3, g)
            tmp = (safe_g * safe_g - 1.0) / (2.0 * uv[:, 0] * safe_g - (safe_g + 1.0))
            cos_e = (tmp * tmp - (1.0 + safe_g * safe_g)) / (2.0 * safe_g)
            cos_e = torch.clamp(cos_e, -1.0, 1.0)
            sin_e = gm.safe_sqrt(1.0 - cos_e * cos_e)
            azim = 2.0 * math.pi * uv[:, 1]
            hg = gm.to_world(gm.make_frame(din), torch.stack(
                [sin_e * torch.cos(azim), sin_e * torch.sin(azim), cos_e], dim=-1))
            val = torch.where(torch.abs(g) < 1e-3, uniform, hg)
            out = W(medium_id == i, val, out)
    return out


def update_medium(vertex, d, medium_id):
    """Index-matched medium transition at a surface crossing
    (reference: src/vol_path_tracing.h:157-171)."""
    transition = vertex.interior_medium_id != vertex.exterior_medium_id
    going_out = gm.dot(d, vertex.geom_normal) > 0
    new_id = torch.where(going_out, vertex.exterior_medium_id, vertex.interior_medium_id)
    return torch.where(transition, new_id, medium_id)
