"""Batched (SoA) texture and environment-map lookups on tensors.

Counterpart of gdpt_tpu/ops/textures_soa.py. Image textures read the
flat mip pool (scene/textures.py) through (N,) gathers on component
tensors, either at level 0 (bilinear) or, when the caller supplies a
per-lane footprint, through fractional-level trilinear mip filtering
(reference: src/mipmap.h:76-88, src/texture.h:129-139). Gathers clip
their indices (soa.take) and texel coordinates truncate as the
reference's do: one texel off is a visible difference.

Environment-map importance sampling uses the flat alias table over the
envmap's texels (core/distributions.py) for O(1) sampling, and its pdf
the 2D table of the reference (src/table_dist.cpp:119-143).
"""

import math
from typing import NamedTuple

import torch

from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import INT, REAL
from gdpt_tpu_torch.core.soa import V3


class Pool3SoA(NamedTuple):
    data: V3                  # components of the (n_pixels, 3) pool
    level_offset: torch.Tensor
    level_w: torch.Tensor
    level_h: torch.Tensor
    n_levels: torch.Tensor


def pool3_soa(pool) -> Pool3SoA:
    return Pool3SoA(
        soa.from_rows(pool.data),
        pool.level_offset, pool.level_w, pool.level_h, pool.n_levels,
    )


class Pool1SoA(NamedTuple):
    data: torch.Tensor        # (n_pixels,) flat 1-channel pool
    level_offset: torch.Tensor
    level_w: torch.Tensor
    level_h: torch.Tensor
    n_levels: torch.Tensor


def pool1_soa(pool) -> Pool1SoA:
    return Pool1SoA(
        pool.data[:, 0].contiguous(),
        pool.level_offset, pool.level_w, pool.level_h, pool.n_levels,
    )


def _level_view(pool, img_id, lvl):
    """(w, h, offset) of mip level lvl for each lane's image. The level
    tables are (n_images, max_levels); a flat take handles the per-lane
    level index."""
    L = pool.level_w.shape[1]
    flat = img_id * L + lvl
    w = soa.take(pool.level_w.reshape(-1), flat)
    h = soa.take(pool.level_h.reshape(-1), flat)
    off = soa.take(pool.level_offset.reshape(-1), flat)
    return w, h, off


def _tap(gather, data, w, h, off, u, v):
    """One bilinear tap (pixel-center convention, wrap addressing;
    reference: src/mipmap.h:50-72) through `gather` on `data`."""
    x = u * w.to(REAL) - 0.5
    y = v * h.to(REAL) - 0.5
    x0 = torch.floor(x).to(INT)
    y0 = torch.floor(y).to(INT)
    fx = x - x0.to(REAL)
    fy = y - y0.to(REAL)
    x0m = torch.remainder(x0, w)
    y0m = torch.remainder(y0, h)
    x1m = torch.remainder(x0 + 1, w)
    y1m = torch.remainder(y0 + 1, h)
    p00 = gather(data, off + y0m * w + x0m)
    p01 = gather(data, off + y1m * w + x0m)
    p10 = gather(data, off + y0m * w + x1m)
    p11 = gather(data, off + y1m * w + x1m)
    return (p00 * ((1 - fx) * (1 - fy)) + p10 * (fx * (1 - fy))
            + p01 * ((1 - fx) * fy) + p11 * (fx * fy))


def _clip(x, lo, hi):
    """jnp.clip: max with lo, then min with hi (hi may be a tensor)."""
    return torch.minimum(torch.clamp_min(x, lo), hi)


def _trilinear(pool, gather, img_id, u, v, level):
    """Fractional-level mip lookup: two bilinear taps lerped
    (reference: src/mipmap.h:76-88, src/texture.h:132-139)."""
    max_level = soa.take(pool.n_levels, img_id) - 1
    l0 = _clip(torch.floor(level).to(INT), 0, max_level)
    l1 = _clip(l0 + 1, 0, max_level)
    frac = torch.clamp(level - l0.to(REAL), 0.0, 1.0)
    frac = torch.where(level <= 0, 0.0, frac)
    w0, h0, o0 = _level_view(pool, img_id, l0)
    w1, h1, o1 = _level_view(pool, img_id, l1)
    a = _tap(gather, pool.data, w0, h0, o0, u, v)
    b = _tap(gather, pool.data, w1, h1, o1, u, v)
    return a * (1.0 - frac) + b * frac


def trilinear(pool: Pool3SoA, img_id, u, v, level) -> V3:
    """Per-lane trilinear mip lookup, 3-channel pools."""
    return _trilinear(pool, soa.gather, img_id, u, v, level)


def trilinear_f(pool: Pool1SoA, img_id, u, v, level):
    """Per-lane trilinear mip lookup, 1-channel (float slot) pools."""
    return _trilinear(pool, soa.take, img_id, u, v, level)


def footprint_level(pool, img_id, uscale, vscale, fp):
    """log2 mip level from a uv-space screen footprint (reference:
    src/texture.h:129-139)."""
    w0 = soa.take(pool.level_w[:, 0], img_id).to(REAL)
    h0 = soa.take(pool.level_h[:, 0], img_id).to(REAL)
    scaled = torch.maximum(w0, h0) * torch.maximum(uscale, vscale) * fp
    return torch.log2(torch.clamp_min(scaled, 1e-8))


def _level0(pool, img_id):
    return (soa.take(pool.level_w[:, 0], img_id), soa.take(pool.level_h[:, 0], img_id),
            soa.take(pool.level_offset[:, 0], img_id))


def bilinear_level0_f(pool: Pool1SoA, img_id, u, v):
    """1-channel twin of bilinear_level0 (float texture slots:
    roughness/metallic/... maps, reference src/texture.h Texture<Real>)."""
    return _tap(soa.take, pool.data, *_level0(pool, img_id), u, v)


def bilinear_level0(pool: Pool3SoA, img_id, u, v) -> V3:
    """Bilinear tap at mip level 0 (reference: src/mipmap.h:50-72
    pixel-center convention)."""
    return _tap(soa.gather, pool.data, *_level0(pool, img_id), u, v)


def searchsorted_rows(rows_flat, row_stride, y_idx, u, n_cols):
    """Per-lane ``searchsorted(rows[y], u, 'right') - 1``: bisection over
    cdf positions [0, n_cols] with clip-mode flat gathers, the reference's
    fixed number of steps. rows_flat = rows.reshape(-1) where rows is
    (h, n_cols + 1)."""
    lo = torch.zeros_like(y_idx)
    hi = torch.full_like(y_idx, n_cols)
    base = y_idx * row_stride
    steps = max(int(math.ceil(math.log2(n_cols + 1))), 1) + 1
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        val = soa.take(rows_flat, base + mid)
        go_right = val <= u
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    return torch.clamp(lo - 1, 0, n_cols - 1)


class EnvmapSoA(NamedTuple):
    """A render's view of the envmap tables; tex_kind, width and height
    are Python ints (branch selectors)."""

    to_world: torch.Tensor  # (4, 4)
    to_local: torch.Tensor
    scale: torch.Tensor
    tex_kind: int           # TEX_CONST or TEX_IMAGE
    const_value: V3         # () components (unscaled)
    img_id: torch.Tensor
    cdf_rows: torch.Tensor
    pdf_rows: torch.Tensor
    cdf_marginals: torch.Tensor
    pdf_marginals: torch.Tensor
    # Flat alias table over the w*h texels (core/distributions.py
    # build_alias_table): O(1) sampling.
    alias_cut: torch.Tensor
    alias_idx: torch.Tensor
    width: int
    height: int
    # Dense (h*w, 3) copy of the env image's mip level 0, or None: one
    # row gather per tap in place of three component gathers.
    img3: object = None


def _xform_vec(m, v: V3) -> V3:
    return V3(
        m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z,
        m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z,
        m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z,
    )


def envmap_uv_from_dir(env: EnvmapSoA, wdir: V3):
    """World direction (scene -> env) to (u, v, sin_elevation)
    (reference: src/lights/envmap.inl:44-56; y-up convention)."""
    local = _xform_vec(env.to_local, wdir)
    u = torch.arctan2(local.x, -local.z) / (2.0 * math.pi)
    u = torch.where(u < 0, u + 1.0, u)
    v = torch.arccos(torch.clamp(local.y, -1.0, 1.0)) / math.pi
    sin_e = torch.sqrt(torch.clamp_min(1.0 - local.y * local.y, 0.0))
    return u, v, sin_e


def _envmap_radiance_uv(env: EnvmapSoA, pool: Pool3SoA, u, v) -> V3:
    """Unscaled level-0 bilinear env radiance at (u, v): through the
    dense (h*w, 3) copy when there is one, else the pool."""
    if env.tex_kind != 1:  # TEX_CONST
        ones = torch.ones_like(u)
        return V3(ones * env.const_value.x, ones * env.const_value.y,
                  ones * env.const_value.z)
    if env.img3 is None:
        img_id = torch.zeros_like(u, dtype=INT) + env.img_id
        return bilinear_level0(pool, img_id, u, v)
    w, h = env.width, env.height
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x).to(INT)
    y0 = torch.floor(y).to(INT)
    fx = x - x0.to(REAL)
    fy = y - y0.to(REAL)
    x0m = torch.remainder(x0, w)
    y0m = torch.remainder(y0, h)
    x1m = torch.remainder(x0 + 1, w)
    y1m = torch.remainder(y0 + 1, h)
    img = env.img3
    p00 = soa.take(img, y0m * w + x0m)
    p01 = soa.take(img, y1m * w + x0m)
    p10 = soa.take(img, y0m * w + x1m)
    p11 = soa.take(img, y1m * w + x1m)
    o = (p00 * ((1 - fx) * (1 - fy))[:, None]
         + p10 * (fx * (1 - fy))[:, None]
         + p01 * ((1 - fx) * fy)[:, None]
         + p11 * (fx * fy)[:, None])
    return V3(o[:, 0], o[:, 1], o[:, 2])


def envmap_emission_soa(env: EnvmapSoA, pool: Pool3SoA, dir_to_env: V3,
                        spread=None) -> V3:
    """Radiance arriving along dir_to_env. Image envmaps are always a
    level-0 bilinear lookup, as the reference's are: its footprint
    (src/lights/envmap.inl:60-72) keeps the negative dvdwy through min()
    and never applies the ray spread, so texture.h clamps the level far
    below 0. `spread` is accepted and unused, as there."""
    del spread
    u, v, _ = envmap_uv_from_dir(env, dir_to_env)
    return _envmap_radiance_uv(env, pool, u, v) * env.scale


def envmap_emission_pdf_soa(env: EnvmapSoA, pool: Pool3SoA, dir_to_env: V3):
    """(scaled radiance, NEE-sampler solid-angle pdf) for one direction,
    sharing one uv transform."""
    u, v, sin_e = envmap_uv_from_dir(env, dir_to_env)
    rad = _envmap_radiance_uv(env, pool, u, v) * env.scale
    return rad, _envmap_pdf_uv(env, u, v, sin_e)


def _pdf_uv_texel(env: EnvmapSoA, x, y):
    w, h = env.width, env.height
    return (soa.take(env.pdf_marginals, y)
            * soa.take(env.pdf_rows.reshape(-1), y * w + x)
            * w * h)


def _solid_angle(pdf_uv, sin_e):
    return torch.where(
        sin_e > 0, pdf_uv / torch.clamp_min(2.0 * math.pi * math.pi * sin_e, 1e-20), 0.0)


def envmap_sample_dir(env: EnvmapSoA, u0, u1):
    """Importance-sample a direction toward the envmap; returns
    (world_dir, pdf_solid_angle). The reference's distribution
    (src/lights/envmap.inl:8-42 + src/table_dist.cpp:119-143): a texel
    with probability proportional to its luminance, uniform jitter
    within it, through a flat alias table (two gathers). For constant
    envmaps the tables are the dummy uniform 2x2 grid: uniform uv with
    pdf_uv = 1."""
    from gdpt_tpu_torch.core import distributions as dist

    h, w = env.height, env.width
    k, dx = dist.sample_alias(env.alias_cut, env.alias_idx, u0)
    x = torch.remainder(k, w)
    y = torch.div(k, w, rounding_mode="floor")
    dy = u1
    uu = (x.to(REAL) + dx) / w
    vv = (y.to(REAL) + dy) / h
    azimuth = uu * 2.0 * math.pi
    elevation = vv * math.pi
    local = V3(
        torch.sin(azimuth) * torch.sin(elevation),
        torch.cos(elevation),
        -torch.cos(azimuth) * torch.sin(elevation),
    )
    wdir = _xform_vec(env.to_world, local)
    pdf_uv = _pdf_uv_texel(env, x, y)
    return wdir, _solid_angle(pdf_uv, torch.sin(elevation))


def _envmap_pdf_uv(env: EnvmapSoA, u, v, sin_e):
    """Solid-angle density of envmap_sample_dir at precomputed (u, v)
    (reference: src/lights/envmap.inl:58-73)."""
    h, w = env.height, env.width
    x = torch.clamp((u * w).to(INT), 0, w - 1)
    y = torch.clamp((v * h).to(INT), 0, h - 1)
    return _solid_angle(_pdf_uv_texel(env, x, y), sin_e)


def envmap_pdf_dir(env: EnvmapSoA, wdir: V3):
    """Solid-angle density of envmap_sample_dir at wdir."""
    u, v, sin_e = envmap_uv_from_dir(env, wdir)
    return _envmap_pdf_uv(env, u, v, sin_e)
