"""Tabulated sampling distributions, built on the host in numpy.

Counterpart of gdpt_tpu/core/distributions.py (reference:
src/table_dist.h/.cpp): the table constructors, the alias table with
its sampler (the SoA renders' envmap NEE), and the 2D table's per-lane
sampler and density (the per-ray integrators' envmap). The light CDF is
sampled with torch.searchsorted directly.
"""

from typing import NamedTuple

import numpy as np
import torch

from gdpt_tpu_torch.core.dtypes import INT, REAL, asarray


class TableDist1D(NamedTuple):
    pmf: torch.Tensor  # (n,)
    cdf: torch.Tensor  # (n + 1,)


def make_table_dist_1d(f) -> TableDist1D:
    f = np.asarray(f, dtype=np.float64)
    n = f.shape[0]
    cdf = np.concatenate([[0.0], np.cumsum(f)])
    total = cdf[-1]
    if total > 0:
        pmf = f / total
        cdf = cdf / total
    else:
        # Degenerate input: uniform (reference: src/table_dist.cpp:17-24).
        pmf = np.full(n, 1.0 / n)
        cdf = np.arange(n + 1) / n
    cdf[-1] = 1.0
    return TableDist1D(asarray(pmf, REAL), asarray(cdf, REAL))


class TableDist2D(NamedTuple):
    """Piecewise-constant 2D distribution over [0,1]^2 (reference:
    src/table_dist.h:27-36): per-row conditional CDFs plus a marginal."""

    cdf_rows: torch.Tensor       # (h, w + 1)
    pdf_rows: torch.Tensor       # (h, w)
    cdf_marginals: torch.Tensor  # (h + 1,)
    pdf_marginals: torch.Tensor  # (h,)
    total_values: float
    width: int
    height: int


def make_table_dist_2d(f, width, height) -> TableDist2D:
    f = np.asarray(f, dtype=np.float64).reshape(height, width)
    cdf_rows = np.zeros((height, width + 1))
    cdf_rows[:, 1:] = np.cumsum(f, axis=1)
    row_integrals = cdf_rows[:, -1].copy()
    pdf_rows = np.empty_like(f)
    for y in range(height):
        if row_integrals[y] > 0:
            cdf_rows[y, :-1] /= row_integrals[y]
            pdf_rows[y] = f[y] / row_integrals[y]
        else:
            pdf_rows[y] = 1.0 / width
            cdf_rows[y, :-1] = np.arange(width) / width
        cdf_rows[y, -1] = 1.0

    cdf_marginals = np.concatenate([[0.0], np.cumsum(row_integrals)])
    total = cdf_marginals[-1]
    pdf_marginals = np.empty(height)
    if total > 0:
        cdf_marginals /= total
        pdf_marginals[:] = row_integrals / total
    else:
        pdf_marginals[:] = 1.0 / height
        cdf_marginals[:-1] = np.arange(height + 1)[:-1] / height
    cdf_marginals[-1] = 1.0

    return TableDist2D(
        asarray(cdf_rows, REAL),
        asarray(pdf_rows, REAL),
        asarray(cdf_marginals, REAL),
        asarray(pdf_marginals, REAL),
        float(total),
        width,
        height,
    )


def build_alias_table(weights):
    """Vose alias table (cut f32[N], alias i32[N]) for O(1) categorical
    sampling: keep k where frac < cut[k], else take alias[k]."""
    w = np.asarray(weights, np.float64).ravel()
    n = w.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=REAL), torch.zeros(0, dtype=INT)
    total = w.sum()
    if not np.isfinite(total) or total <= 0:
        w = np.ones(n)
        total = float(n)
    p = w * (n / total)  # mean 1
    cut = np.ones(n)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        cut[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for i in small + large:
        cut[i] = 1.0
        alias[i] = i
    return asarray(cut, REAL), asarray(alias, INT)


def sample_alias(cut, alias, u):
    """Categorical index and a re-uniformized leftover in [0, 1): keep
    k = floor(u * N) where the coin's fraction is below cut[k], else take
    alias[k]; the leftover re-stretches the coin to a uniform, so callers
    reuse it as in-cell jitter."""
    n = cut.shape[0]
    un = u * n
    k = torch.clamp(un.to(INT), 0, n - 1)
    f = un - k.to(un.dtype)
    c = cut[k.long()]
    a = alias[k.long()]
    keep = f < c
    idx = torch.where(keep, k, a)
    left = torch.where(keep, f / torch.clamp_min(c, 1e-12),
                       (f - c) / torch.clamp_min(1.0 - c, 1e-12))
    return idx, torch.clamp(left, 0.0, 0.999999)


def sample_2d(table: TableDist2D, uv):
    """Per-lane (u, v) in [0,1]^2 from uv (N, 2), density proportional to
    the table: a row from the marginal, a column from the row's
    conditional, then a uniform remap within the cell (reference:
    src/table_dist.cpp:119-143)."""
    w, h = table.width, table.height
    u, v = uv[:, 0].contiguous(), uv[:, 1].contiguous()
    y = torch.clamp(torch.searchsorted(table.cdf_marginals, v, right=True) - 1, 0, h - 1)
    cm0 = table.cdf_marginals[y]
    cm1 = table.cdf_marginals[y + 1]
    dy = torch.where(cm1 - cm0 > 0, (v - cm0) / torch.where(cm1 - cm0 > 0, cm1 - cm0, 1.0),
                     v - cm0)
    row_cdf = table.cdf_rows[y]
    x = torch.clamp(torch.searchsorted(row_cdf, u[:, None], right=True)[:, 0] - 1, 0, w - 1)
    c0 = row_cdf.gather(1, x[:, None])[:, 0]
    c1 = row_cdf.gather(1, x[:, None] + 1)[:, 0]
    dx = torch.where(c1 - c0 > 0, (u - c0) / torch.where(c1 - c0 > 0, c1 - c0, 1.0), u - c0)
    return torch.stack([(x + dx) / w, (y + dy) / h], dim=-1)


def pdf_2d(table: TableDist2D, uv):
    """Density of sample_2d at uv (N, 2)."""
    w, h = table.width, table.height
    x = torch.clamp((uv[:, 0] * w).to(INT), 0, w - 1).long()
    y = torch.clamp((uv[:, 1] * h).to(INT), 0, h - 1).long()
    return table.pdf_marginals[y] * table.pdf_rows[y, x] * w * h
