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


# ---------------------------------------------------------------------------
# core/rng.py: the per-ray integrators' jax.random streams, bit for bit
# ---------------------------------------------------------------------------

RAY_IDX = np.array([0, 1, 2, 255, 65_537, 1_000_003, 2**24 + 5, 2**31 - 2, 2**31 - 1],
                   np.int64)
SLOTS = list(range(11)) + [48]


def _jax_keys(seed):
    import jax

    from gdpt_tpu.core import rng as jr

    base = jax.random.PRNGKey(seed)
    return jax.vmap(lambda i: jr.ray_key(base, i))(np.asarray(RAY_IDX, np.int32))


def _port_keys(seed):
    from gdpt_tpu_torch.core import rng as tr

    return tr.ray_key(tr.prng_key(seed, len(RAY_IDX)), torch.from_numpy(RAY_IDX))


def _key_words(keys):
    import jax

    kd = keys if keys.dtype == np.uint32 else jax.random.key_data(keys)
    return np.asarray(kd).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_ray_key_bits(seed):
    j = _key_words(_jax_keys(seed))
    t0, t1 = _port_keys(seed)
    np.testing.assert_array_equal(j[:, 0], t0.numpy())
    np.testing.assert_array_equal(j[:, 1], t1.numpy())


def test_fold_in_example():
    """fold_in(PRNGKey(42), 7) and its first two uniforms (computed with
    jax 0.9.0)."""
    from gdpt_tpu_torch.core import rng as tr

    k = tr.fold_in(tr.prng_key(42, 1), 7)
    assert (int(k[0]), int(k[1])) == (2547012911, 1371500959)
    u = tr.random_uniform(k, (2,))[0].tolist()
    assert u == [np.float32(0.6135714).item(), np.float32(0.49615705).item()]


@pytest.mark.parametrize("shape", [(), (2,)])
@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_site_key_and_uniform_bits(seed, shape):
    """site_key and uniform at slots 0-10 and 48, bounce 0, 1 and 63."""
    import jax

    from gdpt_tpu.core import rng as jr
    from gdpt_tpu_torch.core import rng as tr

    jk, tk = _jax_keys(seed), _port_keys(seed)
    for bounce in (0, 1, 63):
        for slot in SLOTS:
            js = _key_words(jax.vmap(lambda k: jr.site_key(k, bounce, slot))(jk))
            ts = tr.site_key(tk, bounce, slot)
            np.testing.assert_array_equal(js[:, 0], ts[0].numpy())
            np.testing.assert_array_equal(js[:, 1], ts[1].numpy())
            ju = jax.vmap(lambda k: jr.uniform(k, bounce, slot, shape))(jk)
            tu = tr.uniform(tk, bounce, slot, shape)
            assert tu.dtype == torch.float32 and tuple(tu.shape) == np.shape(ju)
            np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


@pytest.mark.parametrize("shape", [(), (2,)])
def test_uniform_with_per_lane_bounce(shape):
    """A per-lane bounce tensor (b = iters + 1 of the masked loops):
    slot = bounce * 256 + slot per lane."""
    import jax

    from gdpt_tpu.core import rng as jr
    from gdpt_tpu_torch.core import rng as tr

    bounce = np.array([1, 2, 3, 5, 8, 13, 21, 34, 64], np.int32)
    jk, tk = _jax_keys(42), _port_keys(42)
    for slot in SLOTS:
        ju = jax.vmap(lambda k, b: jr.uniform(k, b, slot, shape))(jk, bounce)
        tu = tr.uniform(tk, torch.from_numpy(bounce), slot, shape)
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


@pytest.mark.parametrize("shape", [(), (2,)])
@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_loop_uniform_bits(seed, shape):
    import jax

    from gdpt_tpu.core import rng as jr
    from gdpt_tpu_torch.core import rng as tr

    jk, tk = _jax_keys(seed), _port_keys(seed)
    for bounce, slot, it in ((0, 10, 0), (3, 10, 7), (2, 48, 15), (64, 48, 1000)):
        ju = jax.vmap(lambda k: jr.loop_uniform(k, bounce, slot, it, shape))(jk)
        tu = tr.loop_uniform(tk, bounce, slot, it, shape)
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
