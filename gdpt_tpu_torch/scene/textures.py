"""Texture descriptors and the flat mip pool, host side.

Counterpart of the host half of gdpt_tpu/scene/textures.py: every mip
level of every image is flattened into one pixel array, with
(image, level) -> (offset, width, height) tables (reference:
src/texture.h:13-78, src/mipmap.h:25-48). The SoA renders' image
lookups are the batched ones of ops/textures_soa.py; the device half
here (gather_desc, eval_texture, eval_tex1/3, lookup_trilinear,
_bilinear) serves the per-ray integrators, one lane per (pixel, sample)
ray along the leading dimension.

Texture kinds (reference: src/texture.h:80-115): 0 constant, 1 image,
2 checkerboard.
"""

from typing import NamedTuple

import numpy as np
import torch

from gdpt_tpu_torch.core.dtypes import INT, REAL, asarray

TEX_CONST = 0
TEX_IMAGE = 1
TEX_CHECKER = 2

MAX_MIP_LEVELS = 8


def build_mipmap(img):
    """2x2 box-filter pyramid, at most 8 levels (reference: src/mipmap.h:25-48)."""
    img = np.asarray(img, np.float32)
    levels = [img]
    size = max(img.shape[0], img.shape[1])
    n_levels = min(int(np.ceil(np.log2(max(size, 1)) + 1)), MAX_MIP_LEVELS)
    for _ in range(1, n_levels):
        prev = levels[-1]
        h, w = prev.shape[:2]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        ys0 = np.minimum(2 * np.arange(nh), h - 1)
        ys1 = np.minimum(2 * np.arange(nh) + 1, h - 1)
        xs0 = np.minimum(2 * np.arange(nw), w - 1)
        xs1 = np.minimum(2 * np.arange(nw) + 1, w - 1)
        nxt = (
            prev[np.ix_(ys0, xs0)] + prev[np.ix_(ys0, xs1)]
            + prev[np.ix_(ys1, xs0)] + prev[np.ix_(ys1, xs1)]
        ) / 4.0
        levels.append(nxt.astype(np.float32))
    return levels


class TexturePoolArrays(NamedTuple):
    """One pool instance holds either 3-channel or 1-channel images."""

    data: torch.Tensor          # (n_pixels, C)
    level_offset: torch.Tensor  # (n_images, MAX_MIP_LEVELS)
    level_w: torch.Tensor       # (n_images, MAX_MIP_LEVELS)
    level_h: torch.Tensor       # (n_images, MAX_MIP_LEVELS)
    n_levels: torch.Tensor      # (n_images,)


def build_texture_pool(images, channels):
    """images: list of (h, w[, c]) float arrays."""
    if not images:
        z = np.zeros((1, channels), np.float32)
        zi = np.zeros((1, MAX_MIP_LEVELS), np.int32)
        return TexturePoolArrays(
            asarray(z), asarray(zi), asarray(zi + 1),
            asarray(zi + 1), asarray(np.ones(1, np.int32)),
        )
    chunks, off, lvl_off, lvl_w, lvl_h, n_lvls = [], 0, [], [], [], []
    for img in images:
        img = np.asarray(img, np.float32).reshape(img.shape[0], img.shape[1], -1)
        levels = build_mipmap(img)
        offs = np.zeros(MAX_MIP_LEVELS, np.int64)
        ws = np.ones(MAX_MIP_LEVELS, np.int64)
        hs = np.ones(MAX_MIP_LEVELS, np.int64)
        for i, lv in enumerate(levels):
            offs[i] = off
            hs[i], ws[i] = lv.shape[0], lv.shape[1]
            chunks.append(lv.reshape(-1, img.shape[2]))
            off += lv.shape[0] * lv.shape[1]
        # Saturate unused level slots at the coarsest level.
        for i in range(len(levels), MAX_MIP_LEVELS):
            offs[i], ws[i], hs[i] = offs[len(levels) - 1], ws[len(levels) - 1], hs[len(levels) - 1]
        lvl_off.append(offs)
        lvl_w.append(ws)
        lvl_h.append(hs)
        n_lvls.append(len(levels))
    return TexturePoolArrays(
        asarray(np.concatenate(chunks, axis=0)),
        asarray(np.stack(lvl_off).astype(np.int32)),
        asarray(np.stack(lvl_w).astype(np.int32)),
        asarray(np.stack(lvl_h).astype(np.int32)),
        asarray(np.asarray(n_lvls, np.int32)),
    )


class TexDesc(NamedTuple):
    """Per-slot texture descriptor, batched over materials. value doubles
    as the constant color (kind 0) and checker color0 (kind 2); value2 is
    checker color1. C = 3 for spectrum slots, C = 1 for float slots."""

    kind: torch.Tensor     # (M,)
    value: torch.Tensor    # (M, C)
    value2: torch.Tensor   # (M, C)
    img_id: torch.Tensor   # (M,)
    uscale: torch.Tensor   # (M,)
    vscale: torch.Tensor
    uoffset: torch.Tensor
    voffset: torch.Tensor


def _bilinear(pool: TexturePoolArrays, img_id, level, u, v):
    """One bilinear tap per lane at integer mip level (reference:
    src/mipmap.h:50-72); the -0.5 shift is Mitsuba's pixel-center
    convention. Returns (N, C)."""
    img_id, level = img_id.long(), level.long()
    w = pool.level_w[img_id, level]
    h = pool.level_h[img_id, level]
    off = pool.level_offset[img_id, level]
    x = u * w.to(REAL) - 0.5
    y = v * h.to(REAL) - 0.5
    x0 = torch.floor(x).to(INT)
    y0 = torch.floor(y).to(INT)
    fx = (x - x0.to(REAL))[:, None]
    fy = (y - y0.to(REAL))[:, None]
    x0m = torch.remainder(x0, w)
    y0m = torch.remainder(y0, h)
    x1m = torch.remainder(x0 + 1, w)
    y1m = torch.remainder(y0 + 1, h)
    p00 = pool.data[(off + y0m * w + x0m).long()]
    p01 = pool.data[(off + y1m * w + x0m).long()]
    p10 = pool.data[(off + y0m * w + x1m).long()]
    p11 = pool.data[(off + y1m * w + x1m).long()]
    return (
        p00 * ((1 - fx) * (1 - fy))
        + p10 * (fx * (1 - fy))
        + p01 * ((1 - fx) * fy)
        + p11 * (fx * fy)
    )


def lookup_trilinear(pool: TexturePoolArrays, img_id, u, v, level):
    """Trilinear mip lookup with a fractional level per lane (reference:
    src/mipmap.h:76-88). Returns (N, C)."""
    max_level = pool.n_levels[img_id.long()] - 1
    l0 = torch.minimum(torch.clamp_min(torch.floor(level).to(INT), 0), max_level)
    l1 = torch.minimum(torch.clamp_min(l0 + 1, 0), max_level)
    frac = torch.clamp(level - l0.to(REAL), 0.0, 1.0)
    frac = torch.where(level <= 0, 0.0, frac)[:, None]
    a = _bilinear(pool, img_id, l0, u, v)
    b = _bilinear(pool, img_id, l1, u, v)
    return a * (1.0 - frac) + b * frac


def eval_texture(pool: TexturePoolArrays, desc_row: TexDesc, uv, footprint):
    """Evaluate gathered TexDesc rows (one per lane) at uv (N, 2) with a
    screen footprint (N,); returns (N, C). Image textures as reference:
    src/texture.h:129-139 (uv wrap, log2 footprint level, trilinear mip
    lookup), checkerboards as src/texture.h:141-152."""
    kind, value, value2, img_id, us, vs, uo, vo = desc_row
    lu = torch.remainder(uv[:, 0] * us + uo, 1.0)
    lv = torch.remainder(uv[:, 1] * vs + vo, 1.0)
    img = img_id.long()
    w0 = pool.level_w[img, 0].to(REAL)
    h0 = pool.level_h[img, 0].to(REAL)
    scaled_fp = torch.maximum(w0, h0) * torch.maximum(us, vs) * footprint
    level = torch.log2(torch.clamp_min(scaled_fp, 1e-8))
    img_val = lookup_trilinear(pool, img_id, lu, lv, level)
    cx = 2 * torch.remainder((lu * 2).to(INT), 2) - 1
    cy = 2 * torch.remainder((lv * 2).to(INT), 2) - 1
    checker = torch.where((cx * cy == 1)[:, None], value, value2)
    return torch.where(
        (kind == TEX_IMAGE)[:, None], img_val,
        torch.where((kind == TEX_CHECKER)[:, None], checker, value),
    )


def eval_tex3(pool, desc: TexDesc, mat_id, uv, footprint):
    """Spectrum slot of the materials mat_id (N,): returns (N, 3)."""
    return eval_texture(pool, gather_desc(desc, mat_id.long()), uv, footprint)


def eval_tex1(pool, desc: TexDesc, mat_id, uv, footprint):
    """Float slot of the materials mat_id (N,): returns (N,)."""
    return eval_texture(pool, gather_desc(desc, mat_id.long()), uv, footprint)[:, 0]


def gather_desc(desc: TexDesc, idx):
    """The slot descriptors of the materials `idx` (a tensor of ids)."""
    return TexDesc(*(f[idx] for f in desc))


def make_tex_desc(host_descs, channels):
    """host_descs: list of dicts with keys kind, value, value2, img_id,
    uscale, vscale, uoffset, voffset. Returns a batched TexDesc."""
    n = len(host_descs)
    cshape = (n, channels)
    kind = np.zeros(n, np.int32)
    value = np.zeros(cshape, np.float32)
    value2 = np.zeros(cshape, np.float32)
    img_id = np.zeros(n, np.int32)
    us = np.ones(n, np.float32)
    vs = np.ones(n, np.float32)
    uo = np.zeros(n, np.float32)
    vo = np.zeros(n, np.float32)
    for i, d in enumerate(host_descs):
        kind[i] = d.get("kind", TEX_CONST)
        value[i] = d.get("value", 0.0)
        value2[i] = d.get("value2", 0.0)
        img_id[i] = d.get("img_id", 0)
        us[i] = d.get("uscale", 1.0)
        vs[i] = d.get("vscale", 1.0)
        uo[i] = d.get("uoffset", 0.0)
        vo[i] = d.get("voffset", 0.0)
    return TexDesc(*(asarray(a) for a in (kind, value, value2, img_id,
                                            us, vs, uo, vo)))
