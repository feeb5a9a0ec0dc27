"""Pixel reconstruction filters, importance-sampled per pixel.

Counterpart of gdpt_tpu/scene/filters.py: the subpixel uniforms are
warped through the filter's inverse CDF instead of splatting (reference:
src/filter.h:7-28). Kinds: 0 = Box, 1 = Tent, 2 = Gaussian.
"""

import math

import torch

FILTER_BOX = 0
FILTER_TENT = 1
FILTER_GAUSSIAN = 2


def sample_box(u, width):
    """Warp [0,1]^2 to [-w/2, w/2]^2 (reference: src/filters/box.inl)."""
    return (2.0 * u - 1.0) * (width / 2.0)


def sample_tent(u, width):
    """Inverse-CDF of the tent filter (reference: src/filters/tent.inl)."""
    h = width / 2.0

    def one(x):
        lo = h * (torch.sqrt(torch.clamp_min(2.0 * x, 0.0)) - 1.0)
        hi = h * (1.0 - torch.sqrt(torch.clamp_min(1.0 - 2.0 * (x - 0.5), 0.0)))
        return torch.where(x < 0.5, lo, hi)

    return torch.stack([one(u[..., 0]), one(u[..., 1])], dim=-1)


def sample_gaussian(u, stddev):
    """Box-Muller (reference: src/filters/gaussian.inl)."""
    r = stddev * torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[..., 0], 1e-8)))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def sample_filter(kind: int, param: float, u):
    if kind == FILTER_BOX:
        return sample_box(u, param)
    if kind == FILTER_TENT:
        return sample_tent(u, param)
    if kind == FILTER_GAUSSIAN:
        return sample_gaussian(u, param)
    raise ValueError(f"unknown filter kind {kind}")
