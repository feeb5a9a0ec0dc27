"""The screened-Poisson reconstruction of the fork's gradient-domain
driver (fourierSolve, src/render.cpp:172-254), in float64.

Per channel it solves (alpha - Laplacian) f = alpha * u - div g, with
gx[x] an estimate of u[x] - u[x-1] (likewise gy along y). The
divergence is the forward difference of g with the fork's reflective
boundary factors: the first and last column of div_x are -2 gx there
(rows of div_y alike). The Laplacian reflects at the border, so the
DCT-I diagonalises it with eigenvalues 2 cos(pi k / (w - 1)) - 4 +
2 cos(pi l / (h - 1)). The solve takes the DCT-I of the right side,
divides by (alpha - eigenvalue), puts the DCT-I of u back at the
constant mode (the DC restore), transforms back and divides by
4 (w - 1)(h - 1).

The DCT-I (FFTW's REDFT00, y_k = x_0 + (-1)^k x_{n-1} +
2 sum_{j=1}^{n-2} x_j cos(pi j k / (n - 1))) is a product with its
cosine matrix, by definition, not an FFT.
"""

import math

import numpy as np
import torch

from benchmark.reference.gradpath import full_precision


def dct1_matrix(n, device="cpu"):
    """(n, n) float64: row k holds the weights of y_k."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    c = torch.full((n,), 2.0, dtype=torch.float64, device=device)
    c[0] = c[-1] = 1.0
    return torch.cos(math.pi * k[:, None] * k[None, :] / (n - 1)) * c[None, :]


def _dct2(mh, mw, x):
    """The 2-D DCT-I of each channel of x (h, w, c)."""
    return torch.einsum("ky,yxc,lx->klc", mh, x, mw)


def divergence(gx, gy):
    """div g of (h, w, c) float64 tensors, with the fork's border factors."""
    dx = torch.zeros_like(gx)
    dx[:, :-1] = gx[:, 1:] - gx[:, :-1]
    dx[:, 0] = -2.0 * gx[:, 0]
    dx[:, -1] = -2.0 * gx[:, -1]
    dy = torch.zeros_like(gy)
    dy[:-1] = gy[1:] - gy[:-1]
    dy[0] = -2.0 * gy[0]
    dy[-1] = -2.0 * gy[-1]
    return dx + dy


def solve(u, gx, gy, alpha, device="cpu"):
    """The reconstruction f (h, w, 3) float64 numpy of the data term u and
    the backward differences gx, gy ((h, w, 3) arrays), solved on
    `device`."""
    full_precision()
    u, gx, gy = (torch.as_tensor(np.asarray(a, np.float64), device=device) for a in (u, gx, gy))
    h, w = u.shape[:2]
    mh, mw = dct1_matrix(h, device), dct1_matrix(w, device)
    rhs = _dct2(mh, mw, alpha * u - divergence(gx, gy))
    lam_x = 2.0 * torch.cos(math.pi * torch.arange(w, dtype=torch.float64, device=device)
                            / (w - 1))
    lam_y = -4.0 + 2.0 * torch.cos(math.pi * torch.arange(h, dtype=torch.float64,
                                                           device=device) / (h - 1))
    f_hat = rhs / (alpha - (lam_y[:, None] + lam_x[None, :]))[..., None]
    f_hat[0, 0] = _dct2(mh[:1], mw[:1], u)[0, 0]
    return (_dct2(mh, mw, f_hat) / (4.0 * (w - 1) * (h - 1))).cpu().numpy()
