"""The port's screened-Poisson reconstruction against gdpt_tpu's.

gdpt_tpu_torch.ops.poisson is held against gdpt_tpu.ops.poisson on seeded
random (h, w, 3) inputs of odd and even sizes. Tolerance: rtol 1e-4 /
atol 1e-5 (two f32 FFT libraries, pocketfft on both sides but reached
through different wrappers, and f32 cosines that differ by an ulp),
scaled for the unnormalised transforms by the size of their outputs.
The exact-gradient and large-alpha properties are those of
tests/test_gdpt.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gdpt_tpu.ops import poisson as jpoisson
from gdpt_tpu_torch.ops import poisson as tpoisson

SIZES = [(19, 23), (16, 16), (9, 8), (2, 5)]


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(got, ref, scale=1.0):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("n", [2, 3, 8, 17, 64])
def test_dct1_matches_reference_and_definition(n):
    x = _rand((n,), n)
    got = tpoisson.dct1(torch.from_numpy(x))
    _close(got, jpoisson.dct1(jnp.asarray(x)), scale=n)
    k = np.arange(n)
    expect = np.array([
        x[0] + ((-1.0) ** kk) * x[-1]
        + 2.0 * sum(x[j] * np.cos(np.pi * j * kk / (n - 1)) for j in range(1, n - 1))
        for kk in k])
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_dct1_along_an_axis(axis):
    x = _rand((7, 6, 3), 3)
    _close(tpoisson.dct1(torch.from_numpy(x), axis=axis),
           jpoisson.dct1(jnp.asarray(x), axis=axis), scale=8)


@pytest.mark.parametrize("h,w", SIZES)
def test_dct1_2d_matches_reference(h, w):
    x = _rand((h, w, 3), h * w)
    _close(tpoisson.dct1_2d(torch.from_numpy(x)), jpoisson.dct1_2d(jnp.asarray(x)),
           scale=h * w)


@pytest.mark.parametrize("h,w", SIZES)
def test_assemble_gradients_matches_reference(h, w):
    bufs = [_rand((h, w, 3), 10 + i) - 0.5 for i in range(4)]
    before = [b.copy() for b in bufs]
    got = tpoisson.assemble_gradients(*(torch.from_numpy(b) for b in bufs))
    ref = jpoisson.assemble_gradients(*(jnp.asarray(b) for b in bufs))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for b, b0 in zip(bufs, before):  # the inputs are not written to
        np.testing.assert_array_equal(b, b0)


@pytest.mark.parametrize("alpha", [0.04, 1.0])
@pytest.mark.parametrize("h,w", SIZES)
def test_solve_matches_reference(h, w, alpha):
    u = _rand((h, w, 3), 1)
    gx, gy = _rand((h, w, 3), 2) - 0.5, _rand((h, w, 3), 3) - 0.5
    got = tpoisson.screened_poisson_solve(*(torch.from_numpy(a) for a in (u, gx, gy)), alpha)
    ref = jpoisson.screened_poisson_solve(*(jnp.asarray(a) for a in (u, gx, gy)), alpha)
    # The solve amplifies input rounding by up to 1 / alpha at the lowest
    # frequencies.
    _close(got, ref, scale=max(1.0, 1.0 / alpha))


def test_solve_reconstructs_exact_gradients():
    u = torch.from_numpy(_rand((19, 23, 3), 1))
    gx = u - torch.cat([u[:, :1], u[:, :-1]], dim=1)
    gx[:, 0] = u[:, 0] - u[:, 1]
    gy = u - torch.cat([u[:1], u[:-1]], dim=0)
    gy[0] = u[0] - u[1]
    out = tpoisson.screened_poisson_solve(u, gx, gy, 0.04)
    np.testing.assert_allclose(out.numpy(), u.numpy(), atol=1e-4)


def test_solve_with_large_alpha_returns_the_data():
    u = torch.from_numpy(_rand((9, 8, 3), 2))
    out = tpoisson.screened_poisson_solve(u, torch.zeros_like(u), torch.zeros_like(u), 1e7)
    np.testing.assert_allclose(out.numpy(), u.numpy(), atol=1e-3)


def test_solve_takes_float64_and_returns_float32_on_the_inputs_device():
    u = torch.from_numpy(_rand((6, 7, 3), 4)).double()
    out = tpoisson.screened_poisson_solve(u, torch.zeros_like(u), torch.zeros_like(u), 0.5)
    assert out.dtype == torch.float32 and out.device == u.device and out.shape == u.shape
