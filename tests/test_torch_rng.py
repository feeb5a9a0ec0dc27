"""The port's counter-based RNG is bit-identical to gdpt_tpu.core.soa.

Same integer inputs (made with numpy from a seed) go to both packages;
the uint32 words and the f32 uniforms must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdpt_tpu.core import soa as jsoa
from gdpt_tpu_torch.core import soa as tsoa

N = 100_000

# (seed, counter, sample): small values, values above 2^31, the top word.
CASES = [(0, 0, 0), (3, 17, 5), (2**31 + 7, 2**32 - 1, 2**31 + 3), (12345, 64 * 16 + 4, 255)]


def _words(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _same_bits(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_pcg3d_bits(seed):
    w = _words(seed)
    jx, jy = jsoa.pcg3d(jnp.asarray(w[0]), jnp.asarray(w[1]), jnp.asarray(w[2]))
    tx, ty = tsoa.pcg3d(_t(w[0]), _t(w[1]), _t(w[2]))
    assert _same_bits(jx, tx) and _same_bits(jy, ty)


@pytest.mark.parametrize("seed", [0, 1])
def test_threefry2x32_bits(seed):
    w = _words(seed)
    j0, j1 = jsoa.threefry2x32(*(jnp.asarray(x) for x in w))
    t0, t1 = tsoa.threefry2x32(*(_t(x) for x in w))
    assert _same_bits(j0, t0) and _same_bits(j1, t1)


@pytest.mark.parametrize("impl", ["pcg3d", "threefry"])
@pytest.mark.parametrize("case", CASES)
def test_uniform2_exact(monkeypatch, impl, case):
    monkeypatch.setenv("GDPT_RNG", impl)
    seed, counter, sample = case
    stream = _words(7)[0]
    ja, jb = jsoa.uniform2(jnp.uint32(seed), jnp.asarray(stream), counter, sample)
    ta, tb = tsoa.uniform2(seed, _t(stream), counter, sample)
    assert ta.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    assert float(ta.max()) < 1.0 and float(ta.min()) >= 0.0


def test_uniform2_per_lane_counter():
    """A (N,) counter, as the wavefront uses, gives the same bits too."""
    w = _words(3, 4096)
    ja, jb = jsoa.uniform2(jnp.uint32(9), jnp.asarray(w[0]), jnp.asarray(w[1]), 2)
    ta, tb = tsoa.uniform2(9, _t(w[0]), _t(w[1]), 2)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("impl", ["pcg3d", "threefry"])
def test_streams_reused_across_counters(monkeypatch, impl):
    """One Streams object drawn at many counters (per lane, as the
    volumetric loops draw; per-lane samples too) gives the reference's
    bits at each."""
    monkeypatch.setenv("GDPT_RNG", impl)
    w = _words(5, 4096)
    streams = tsoa.Streams(11, _t(w[0]), _t(w[2]))
    for counter in (w[1], 0x60000000 + 2048 * 7 + 3, 2**32 - 1):
        jc = jnp.asarray(counter) if isinstance(counter, np.ndarray) else counter
        ja, jb = jsoa.uniform2(jnp.uint32(11), jnp.asarray(w[0]), jc, jnp.asarray(w[2]))
        ta, tb = streams(_t(counter) if isinstance(counter, np.ndarray) else counter)
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
