"""Screened-Poisson image reconstruction on the inputs' device.

Counterpart of gdpt_tpu/ops/poisson.py (which replaces the FFTW-based
solver of the reference, src/render.cpp:172-254, after Bhat et al.'s
screened Poisson framework): solve (alpha - Laplacian) f = alpha*u - div g
with reflective (Neumann) boundaries, diagonalized by DCT-I. FFTW's
REDFT00 is realized with ``torch.fft.rfft`` over the even extension of
length 2(n-1), in float32 as the reference does, so the whole
reconstruction runs where its inputs live. The reference runs outside
every Pallas kernel here (``jnp.fft``), so ``torch.fft`` is its port.

Conventions: gx[x] estimates u[x] - u[x-1] (backward difference), gy
likewise along y; the divergence stencil uses their forward differences
with the -2 boundary reflection factors of the reference.
"""

import math

import torch

from gdpt_tpu_torch.core.dtypes import REAL


def dct1(x, axis=-1):
    """Unnormalized DCT-I (FFTW REDFT00): y_k = x_0 + (-1)^k x_{n-1}
    + 2 sum_{j=1}^{n-2} x_j cos(pi j k / (n-1)). Self-inverse up to
    2(n-1)."""
    x = x.movedim(axis, -1)
    ext = torch.cat([x, x[..., 1:-1].flip(-1)], dim=-1)  # length 2(n-1)
    y = torch.fft.rfft(ext, dim=-1).real
    return y.to(x.dtype).movedim(-1, axis)


def dct1_2d(x):
    return dct1(dct1(x, axis=0), axis=1)


def screened_poisson_solve(img, gx, gy, alpha):
    """Per-channel screened Poisson solve. img/gx/gy: (h, w, 3) tensors.

    Mirrors fourierSolve (reference: src/render.cpp:172-254): build
    h_hat = alpha*u - div g with boundary reflection factors, DCT,
    divide by (alpha - Laplacian eigenvalues), restore the DC term of u,
    inverse DCT, normalize by 4(w-1)(h-1).
    """
    h, w = img.shape[:2]
    dev = img.device
    img, gx, gy = img.to(REAL), gx.to(REAL), gy.to(REAL)

    # Divergence of g with reflective boundary factors
    # (reference: src/render.cpp:213-224).
    div_x = torch.cat([gx[:, 1:], torch.zeros_like(gx[:, :1])], dim=1) - gx
    div_x[:, 0] = -2.0 * gx[:, 0]
    div_x[:, -1] = -2.0 * gx[:, -1]
    div_y = torch.cat([gy[1:], torch.zeros_like(gy[:1])], dim=0) - gy
    div_y[0] = -2.0 * gy[0]
    div_y[-1] = -2.0 * gy[-1]

    b = alpha * img - div_x - div_y

    # DC term of u's DCT-I: interior samples count twice per axis
    # (reference: src/render.cpp:205-211).
    wx = torch.ones(w, dtype=REAL, device=dev)
    wx[1:-1] = 2.0
    wy = torch.ones(h, dtype=REAL, device=dev)
    wy[1:-1] = 2.0
    dc = torch.einsum("y,x,yxc->c", wy, wx, img)

    bb = dct1_2d(b)
    lap_x = 2.0 * torch.cos(math.pi * torch.arange(w, dtype=REAL, device=dev) / (w - 1))
    lap_y = -4.0 + 2.0 * torch.cos(math.pi * torch.arange(h, dtype=REAL, device=dev) / (h - 1))
    denom = alpha - (lap_y[:, None] + lap_x[None, :])
    f_hat = bb / denom[..., None]
    f_hat[0, 0] = dc
    return (dct1_2d(f_hat) / (4.0 * (w - 1) * (h - 1))).to(REAL)


def assemble_gradients(gx_here, gx_next, gy_here, gy_next):
    """Combine the four one-sided gradient buffers into the backward
    differences the solver expects (reference: src/render.cpp:340-350,
    small_gdpt.cpp:530-538): the estimate at pixel p and the complementary
    estimate recorded at its predecessor are MIS halves and are summed.
    """
    gx = gx_here.clone()
    gx[:, 1:] += gx_next[:, :-1]
    gy = gy_here.clone()
    gy[1:] += gy_next[:-1]
    return gx, gy
