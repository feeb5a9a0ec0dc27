"""The port's per-ray gradient-domain oracle (integrators/gdpt.py:
trace_gdpt and its driver render_gradpath) against gdpt_tpu's, on the
CPU, and the routes that take it.

Both packages render the 16x16 cbox at 2 spp, depth 4, through their
render_gradpath at the same seed: 5-path lockstep on bit-identical RNG
streams, then the screened-Poisson solve. The reconstruction, the NEE
primal, the brute-force primal and both assembled gradients are held
pixel by pixel at the gradpath gate of tests/test_torch_gdpt.py (at least
99% of values within rtol 1e-3 / atol 1e-4, each buffer's mean within
0.1% of the primal's mean: the port casts through K1/K2's plain versions
where the reference walks in XLA, so a hit distance can move by an ulp
and flip a rare shadow or Russian-roulette test). One sample of
trace_gdpt (256 lanes, offsets flattened offset-major) is held buffer by
buffer, lane by lane. tests/test_gdpt.py's
test_gdpt_shared_randoms_produce_correlated_offsets is mirrored on the
port's trace_gdpt.

A render resumed from its first pass (init_acc, start_sample; one sample
a pass with LANES_PER_PASS cut to the pixel count) equals the
uninterrupted render bit for bit. With
ops/materials_soa.supports_soa_materials monkeypatched to False,
render.render takes render_gradpath (the reference's dispatch) and
render_with_checkpoints resumes it bit for bit from a checkpoint of
shape (6, n_pix, 3).

The gpu-marked test renders the 32x32 cbox through render_gradpath on
the card and on the CPU and holds every buffer at the gate with equal
ray counts; this file imports jax only inside the reference helpers, so
it runs with --noconftest where jax is absent.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import gdpt as tgdpt
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.integrators import volpath as tvp
from gdpt_tpu_torch.ops import materials_soa as tmsoa
from gdpt_tpu_torch.scene import presets as tpresets
from gdpt_tpu_torch.utils import checkpoint

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import gate

SEED = 5
BUFFERS = ["recon", "primal", "primal_bf", "gx", "gy"]
_CACHE = {}


def _box(presets, w=16, h=16, spp=2, max_depth=4):
    return presets.cornell_box(w, h, spp=spp, max_depth=max_depth, integrator="gradpath")


def _buffers(recon, aux):
    return dict(aux, recon=np.asarray(recon))


def _reference():
    if "ref" not in _CACHE:
        from gdpt_tpu.integrators import gdpt as jgdpt
        from gdpt_tpu.scene import presets as jpresets

        recon, aux = jgdpt.render_gradpath(_box(jpresets), seed=SEED, return_aux=True)
        _CACHE["ref"] = {k: np.asarray(v) for k, v in _buffers(recon, aux).items()}
    return _CACHE["ref"]


def _port():
    if "port" not in _CACHE:
        for k in tvp.HOST_READS:
            tvp.HOST_READS[k] = 0
        recon, aux, rays = tgdpt.render_gradpath(_box(tpresets), seed=SEED, device="cpu",
                                                 return_aux=True, return_stats=True)
        _CACHE["port"] = (_buffers(recon, aux), rays, tvp.HOST_READS["gdpt"])
    return _CACHE["port"]


@pytest.mark.parametrize("name", BUFFERS)
def test_render_gradpath_matches_reference(name):
    ref = _reference()
    gate(_port()[0][name], ref[name], float(ref["primal"].mean()))


def test_render_gradpath_loop_and_rays():
    """Depth 4: the bounce loop runs at most n_iters + 1 = 5 bodies, so 6
    host reads; every lane casts its base and four offset camera rays,
    and the live lanes cast their shadow, bounce, probe and replay rays."""
    _, rays, reads = _port()
    lanes = 16 * 16 * 2
    assert reads == 6
    assert 5 * lanes < rays < 5 * lanes * 4


def test_one_sample_buffer_by_buffer():
    """trace_gdpt for one sample of every pixel against the reference's
    vmapped trace_gdpt: the six buffers lane by lane."""
    import jax
    import jax.numpy as jnp
    from gdpt_tpu.core import rng as jrng
    from gdpt_tpu.integrators import gdpt as jgdpt
    from gdpt_tpu.scene import presets as jpresets
    from gdpt_tpu_torch.core import rng
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.ops import intersect as isect

    js, ts = _box(jpresets), _box(tpresets)
    n = 256
    pix = np.arange(n)
    xs, ys = (pix % 16).astype(np.float32), (pix // 16).astype(np.float32)
    base = jax.random.PRNGKey(SEED)
    jout = jax.jit(jax.vmap(lambda x, y, p: jgdpt.trace_gdpt(
        js.device, js.static, x, y, jrng.ray_key(base, p * 2))))(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(pix, jnp.int32))
    casts = isect.Casts(path_soa.scene_soa_from_aos(ts).geom)
    key = rng.ray_key(rng.prng_key(SEED, n), torch.arange(n) * 2)
    tout = tgdpt.trace_gdpt(ts.device, ts.static, casts, torch.tensor(xs), torch.tensor(ys),
                            key)
    assert tout._fields == jout._fields
    for name, a, b in zip(tout._fields, tout, jout):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (n, 3)
        assert np.isclose(a, b, rtol=1e-3, atol=1e-4).mean() >= 0.99, name
    assert float(np.abs(tout.gx_here.numpy()).max()) > 0


def test_shared_randoms_produce_correlated_offsets():
    """tests/test_gdpt.py's check on the port: one sample of the furnace
    sphere's pixel (4, 4) keyed as the reference keys it is finite."""
    from gdpt_tpu_torch.core import rng
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.ops import intersect as isect

    sc = tpresets.furnace_sphere(albedo=0.5, emission=1.0, width=8, height=8, spp=1)
    key = rng.ray_key(rng.prng_key(0, 1), torch.tensor([3]))
    casts = isect.Casts(path_soa.scene_soa_from_aos(sc).geom)
    out = tgdpt.trace_gdpt(sc.device, sc.static, casts, torch.tensor([4.0]),
                           torch.tensor([4.0]), key)
    assert all(bool(torch.isfinite(b).all()) and b.shape == (1, 3) for b in out)


def _one_sample_a_pass(monkeypatch, sc):
    monkeypatch.setattr(tgdpt, "LANES_PER_PASS", sc.static.width * sc.static.height)


def test_render_gradpath_resumes_bit_for_bit(monkeypatch):
    sc = _box(tpresets, 8, 8, spp=3, max_depth=3)
    _one_sample_a_pass(monkeypatch, sc)
    captured = {}

    def first(acc, done):
        captured.setdefault("ck", (acc.copy(), done))

    straight, aux = tgdpt.render_gradpath(sc, seed=SEED, device="cpu", return_aux=True,
                                          on_chunk=first)
    acc, done = captured["ck"]
    assert done == 1 and acc.shape == (6, 64, 3)
    resumed, raux = tgdpt.render_gradpath(sc, seed=SEED, device="cpu", return_aux=True,
                                          start_sample=done, init_acc=acc)
    np.testing.assert_array_equal(resumed, straight)
    for k in aux:
        np.testing.assert_array_equal(raux[k], aux[k])


def test_dispatch_and_checkpoint_take_perray_gradpath(tmp_path, monkeypatch):
    """Without the SoA predicate render.render and render_with_checkpoints
    render `gradpath` through render_gradpath; the checkpoint of its first
    pass, (6, n_pix, 3), resumes bit for bit."""
    from gdpt_tpu_torch.integrators import gdpt_soa

    sc = _box(tpresets, 8, 8, spp=3, max_depth=3)
    _one_sample_a_pass(monkeypatch, sc)
    monkeypatch.setattr(tmsoa, "supports_soa_materials", lambda scene: False)
    assert not gdpt_soa.supports_soa_gdpt(sc)
    captured = {}

    def first(acc, done):
        captured.setdefault("ck", (acc.copy(), done))

    straight, aux, rays = tgdpt.render_gradpath(sc, seed=SEED, device="cpu", return_aux=True,
                                                return_stats=True, on_chunk=first)
    img, raux, rrays = trender.render(sc, seed=SEED, device="cpu", return_aux=True,
                                      return_stats=True)
    np.testing.assert_array_equal(img, straight)
    np.testing.assert_array_equal(raux["gx"], aux["gx"])
    assert rrays == rays
    path = str(tmp_path / "ck.npz")
    fp = checkpoint._fingerprint(sc, 3, SEED)
    checkpoint.save_checkpoint(path, *captured["ck"], fp)
    resumed = checkpoint.render_with_checkpoints(sc, seed=SEED, every=1, path=path,
                                                 device="cpu")
    np.testing.assert_array_equal(resumed, straight)
    assert checkpoint.load_checkpoint(path, fp, (6, 64, 3))[1] == 3


@pytest.mark.gpu
def test_cuda_render_gradpath_matches_cpu():
    """The 32x32 cbox through render_gradpath on the card (K1, K2) against
    the plain versions on the CPU: every buffer at the gate, equal rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sc = _box(tpresets, 32, 32, spp=2, max_depth=4)
    a, aa, ra = tgdpt.render_gradpath(sc, seed=3, return_aux=True, return_stats=True)
    b, ba, rb = tgdpt.render_gradpath(sc, seed=3, device="cpu", return_aux=True,
                                      return_stats=True)
    bufs_a, bufs_b = _buffers(a, aa), _buffers(b, ba)
    for name in BUFFERS:
        gate(bufs_a[name], bufs_b[name], float(bufs_b["primal"].mean()))
    assert ra == rb
