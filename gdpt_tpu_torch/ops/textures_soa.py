"""Component views of the texture pools (counterpart of the pool half of
gdpt_tpu/ops/textures_soa.py). Image and envmap lookups are not ported
yet (see ROADMAP.md); material tables carry these views for them."""

from typing import NamedTuple

import torch

from gdpt_tpu_torch.core import soa
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
