"""The port's per-ray `path` oracle (integrators/path.py) against gdpt_tpu's,
on the CPU, and the routes that take it.

Each scene is built with either package's own modules and rendered by
the port's render_samples(scene, path.trace_path) and by the reference's
R.render_samples(scene, path.trace_path) at the same seed. Their RNG
streams are bit-identical (tests/test_torch_rng.py), so the images are
held pixel by pixel at the path gate (at least 99% of values within rtol
1e-3 / atol 1e-4, the mean within 0.1%: the port casts through K1-K3's
plain versions where the reference walks in XLA, so a hit distance can
move by an ulp and flip a rare edge, shadow or Russian-roulette test).
Scenes: the 16x16 cbox at 3 spp, depth 4; the brute-force material box
at 16x16, 2 spp, depth 3 (every material kind, image textures, an image
envmap: both envmap branches, at a primary miss and at a BSDF-sampled
miss); a 16x16 BVH box around a level-3 icosphere (1,280 triangles: the
plain K3 on the packet table), 2 spp, depth 4. The live rays the port
casts equal the sum of the reference's trace_path_stats counts lane by
lane (a jitted vmap of the reference's trace_path_stats, keyed as
render_samples keys its lanes). max_depth = 1 (no bounce body) matches.

Within the port, tests/test_soa.py::test_soa_path_matches_aos_cbox is
mirrored: the SoA `path` render against the per-ray one at that test's
seeds and gates. With ops/materials_soa.supports_soa_materials
monkeypatched to False, render.render takes the per-ray `path` (the
reference's dispatch) and render_with_checkpoints resumes it bit for bit
from a checkpoint of its first pass, shape (n_pix, 3).

The gpu-marked test renders the 32x32 cbox through the per-ray `path`
on the card and on the CPU and holds them at the gate with equal ray
counts; this file imports jax only inside the reference helpers, so it
runs with --noconftest where jax is absent.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import path as tpath
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.ops import materials_soa as tmsoa
from gdpt_tpu_torch.scene import presets as tpresets
from gdpt_tpu_torch.utils import checkpoint

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import gate

SEED = 7
_CACHE = {}


def _scene(kind, pkg):
    """(reference scene if pkg == "ref", else the port's) of a named kind."""
    if pkg == "ref":
        from gdpt_tpu.core import transform as xf
        from gdpt_tpu.scene import build
        from gdpt_tpu.scene import model as M
        from gdpt_tpu.scene import presets
    else:
        from gdpt_tpu_torch.core import transform as xf
        from gdpt_tpu_torch.scene import build
        from gdpt_tpu_torch.scene import model as M
        presets = tpresets
    if kind == "cbox":
        return presets.cornell_box(16, 16, spp=3, max_depth=4)
    if kind == "cbox-depth1":
        return presets.cornell_box(16, 16, spp=2, max_depth=1)
    if kind == "materials":
        from test_torch_materials_render import material_box

        return material_box(M, build, xf, False, max_depth=3)
    from test_torch_bvh import icosphere_box

    return icosphere_box(presets, M, build, xf, 16, 16, 2, level=3, max_depth=4)


def _reference(kind):
    """(image, rays) of the reference: R.render_samples(scene,
    path.trace_path) and the sum of trace_path_stats' per-lane rays."""
    import jax
    import jax.numpy as jnp
    from gdpt_tpu.core import rng as jrng
    from gdpt_tpu.integrators import path as jpath
    from gdpt_tpu.integrators import render as jrender

    js = _scene(kind, "ref")
    st = js.static
    img = np.asarray(jrender.render_samples(js, jpath.trace_path, seed=SEED))
    spp, n_pix = st.options.samples_per_pixel, st.width * st.height
    lane = np.arange(n_pix * spp)
    pix, sample = lane % n_pix, lane // n_pix
    base = jax.random.PRNGKey(SEED)

    def rays_of(x, y, idx):
        return jpath.trace_path_stats(js.device, st, x, y, jrng.ray_key(base, idx))[1]

    rays = jax.jit(jax.vmap(rays_of))(jnp.asarray(pix % st.width, jnp.float32),
                                      jnp.asarray(pix // st.width, jnp.float32),
                                      jnp.asarray(pix * spp + sample, jnp.int32))
    return img, float(np.asarray(rays, np.float64).sum())


def _renders(kind):
    """(reference image, rays, port image, rays), once per process."""
    if kind not in _CACHE:
        ja, jr = _reference(kind)
        ts = _scene(kind, "port")
        ta, tr = trender.render_samples(ts, tpath.trace_path, seed=SEED, return_stats=True)
        _CACHE[kind] = (ja, jr, ta, tr)
    return _CACHE[kind]


KINDS = ["cbox", "materials", "bvh", "cbox-depth1"]


@pytest.mark.parametrize("kind", KINDS)
def test_perray_path_matches_reference(kind):
    ja, _, ta, _ = _renders(kind)
    gate(ta, ja, float(ja.mean()))
    if kind == "materials":
        assert _scene(kind, "port").static.has_envmap
    if kind == "bvh":
        assert not _scene(kind, "port").static.use_brute_force


@pytest.mark.parametrize("kind", KINDS)
def test_perray_path_rays_match_trace_path_stats(kind):
    _, jr, _, tr = _renders(kind)
    assert abs(tr - jr) <= 1e-3 * jr
    if kind == "cbox-depth1":
        assert tr == 16 * 16 * 2  # the camera rays alone


def test_trace_path_stats_per_lane():
    """trace_path is trace_path_stats' radiance; its per-lane rays are one
    camera ray plus two a bounce body (shadow and scatter), summing to the
    live rays cast."""
    from gdpt_tpu_torch.core import rng
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.ops import intersect as isect

    sc = tpresets.cornell_box(8, 8, spp=1, max_depth=4)
    casts = isect.Casts(path_soa.scene_soa_from_aos(sc).geom)
    n = 64
    key = rng.ray_key(rng.prng_key(SEED, n), torch.arange(n))
    xs, ys = (torch.arange(n) % 8).float(), (torch.arange(n) // 8).float()
    rad, rays = tpath.trace_path_stats(sc.device, sc.static, casts, xs, ys, key)
    assert rad.shape == (n, 3) and rays.shape == (n,)
    assert int(casts.rays) == int(rays.sum())
    assert set(np.unique(rays.numpy()).tolist()) <= {1.0, 3.0, 5.0, 7.0}
    np.testing.assert_array_equal(
        tpath.trace_path(sc.device, sc.static, isect.Casts(casts.geom), xs, ys, key), rad)
    assert tpath.max_bounce_iters(sc.static) == 3
    assert tpath.max_bounce_iters(tpresets.cornell_box(8, 8, max_depth=-1).static) == 64


def test_soa_path_matches_perray_cbox():
    """tests/test_soa.py::test_soa_path_matches_aos_cbox inside the port:
    the SoA render (seed 5) and the per-ray render (seed 6), 128 spp, at
    that test's gates (mean within 6%, blurred pixels within 25% at the
    90th percentile)."""
    from gdpt_tpu_torch.integrators import path_soa

    sc = tpresets.cornell_box(width=32, height=32, spp=48, max_depth=4)
    a = path_soa.render_soa(sc, spp=128, seed=5)
    b = trender.render_samples(sc, tpath.trace_path, spp=128, seed=6)
    assert abs(a.mean() - b.mean()) / b.mean() < 0.06, (a.mean(), b.mean())
    ka = a.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3))
    kb = b.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3))
    rel = np.abs(ka - kb) / (kb + 1e-2)
    assert np.quantile(rel, 0.9) < 0.25


def test_dispatch_takes_perray_path(monkeypatch):
    """Without the SoA predicate render.render renders `path` as the
    reference does then: render_samples over path.trace_path."""
    from gdpt_tpu_torch.integrators import path_soa

    sc = tpresets.cornell_box(8, 8, spp=2, max_depth=3)
    monkeypatch.setattr(tmsoa, "supports_soa_materials", lambda scene: False)
    assert not path_soa.supports_soa(sc)
    img, rays = trender.render(sc, seed=SEED, device="cpu", return_stats=True)
    ref, ref_rays = trender.render_samples(sc, tpath.trace_path, seed=SEED, return_stats=True)
    np.testing.assert_array_equal(img, ref)
    assert rays == ref_rays
    monkeypatch.undo()
    assert path_soa.supports_soa(sc)
    assert not np.array_equal(trender.render(sc, seed=SEED, device="cpu"), img)


def test_perray_path_resumes_bit_for_bit(tmp_path, monkeypatch):
    """One sample a pass (MAX_RAYS_PER_PASS cut to the pixel count): the
    first pass checkpointed with the per-ray accumulator's shape
    (n_pix, 3), the render resumed from it by render_with_checkpoints."""
    sc = tpresets.cornell_box(8, 8, spp=3, max_depth=3)
    monkeypatch.setattr(tmsoa, "supports_soa_materials", lambda scene: False)
    monkeypatch.setattr(trender, "MAX_RAYS_PER_PASS", 64)
    path = str(tmp_path / "ck.npz")
    fp = checkpoint._fingerprint(sc, 3, SEED)
    captured = {}

    def first(acc, done):
        captured.setdefault("ck", (acc.copy(), done))

    straight = trender.render_samples(sc, tpath.trace_path, seed=SEED, on_chunk=first)
    acc, done = captured["ck"]
    assert done == 1 and acc.shape == (64, 3)
    checkpoint.save_checkpoint(path, acc, done, fp)
    resumed = checkpoint.render_with_checkpoints(sc, seed=SEED, every=1, path=path,
                                                 device="cpu")
    np.testing.assert_array_equal(resumed, straight)
    assert checkpoint.load_checkpoint(path, fp, (64, 3))[1] == 3


@pytest.mark.gpu
def test_cuda_perray_path_matches_cpu():
    """The 32x32 cbox through the per-ray `path` on the card (K1, K2)
    against the plain versions on the CPU, with equal ray counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gdpt_tpu_torch.scene.build import scene_to

    sc = tpresets.cornell_box(32, 32, spp=2, max_depth=4)
    a, ra = trender.render_samples(scene_to(sc, "cuda"), tpath.trace_path, seed=3,
                                   return_stats=True)
    b, rb = trender.render_samples(scene_to(sc, "cpu"), tpath.trace_path, seed=3,
                                   return_stats=True)
    gate(a, b, float(b.mean()))
    assert ra == rb
