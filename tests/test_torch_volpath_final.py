"""The port's per-ray final volpath version (integrators/volpath.py:
trace_volpath_final, versions 6 and 0) against gdpt_tpu's, on the CPU.

presets.volpath_scene(version=6, hetero=True, with_diffuse_sphere=True)
is built with either package's own modules (presets.build_volpath_scene)
and rendered through each package's render_samples(scene,
trace_fn(static)) at the same seed, 16x16, 3 spp, depth 6: delta-tracking
free flight, ratio-tracked NEE from scattering points and from the
diffuse sphere, MIS. Their RNG streams are bit-identical, so the images
are held pixel by pixel at the path gate (at least 99% of values within
rtol 1e-3 / atol 1e-4, the mean within 0.1%). The reference's per-ray
program counts no rays (every lane runs every cast under its vmap); the
port counts the live rays it casts, which the gpu-marked test holds
equal on the card and on the CPU. Every one of the final version's four
nested loops is counted in volpath.HOST_READS. Version 0 takes the same
program through trace_fn.

tests/test_volpath.py::test_volpath_soa_matches_per_ray_hetero is
mirrored inside the port: volpath_soa against the per-ray final version
at that test's seeds and gates. With ops/materials_soa's predicate
monkeypatched to False, render.render takes the per-ray final version
(the reference's dispatch).

The gpu-marked test renders the 32x32 scene on the card and on the CPU
and holds them at the gate with equal ray counts; this file imports jax
only inside the reference helpers, so it runs with --noconftest where
jax is absent.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.integrators import volpath as tvp
from gdpt_tpu_torch.integrators import volpath_soa as tvsoa
from gdpt_tpu_torch.ops import materials_soa as tmsoa
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import gate
from test_torch_volpath_rungs import SEED, reference_render, scene_pair

FINAL = dict(version=6, width=16, height=16, spp=3, max_depth=6, hetero=True,
             with_diffuse_sphere=True)
_CACHE = {}


def _renders():
    """(reference image, port image, port rays, host reads), once."""
    if "final" not in _CACHE:
        js, ts = scene_pair(**FINAL)
        ja = reference_render(js, SEED)
        for k in tvp.HOST_READS:
            tvp.HOST_READS[k] = 0
        ta, rays = trender.render_samples(ts, tvp.trace_fn(ts.static), seed=SEED,
                                          return_stats=True)
        _CACHE["final"] = (ja, ta, rays, dict(tvp.HOST_READS))
    return _CACHE["final"]


def test_final_version_matches_reference():
    ja, ta, _, _ = _renders()
    gate(ta, ja, float(ja.mean()))
    assert (ta >= 0).all()


def test_final_version_loops_and_rays():
    """The bounce loop (at most 7 bodies at depth 6), the free flights,
    the shadow segments and their ratio tracking all ran; one camera ray
    a lane and more."""
    _, _, rays, reads = _renders()
    assert 2 <= reads["bounce"] <= 8
    assert reads["flight"] > reads["bounce"] and reads["segment"] > reads["bounce"]
    assert reads["ratio"] > 0 and reads["path"] == reads["gdpt"] == 0
    assert rays > 16 * 16 * 3


def test_version_0_is_the_final_version():
    """trace_fn gives versions 6 and 0 the final version; the v0 scene
    renders v6's image bit for bit."""
    kw = dict(FINAL, width=8, height=8, spp=2)
    images = []
    for version in (6, 0):
        sc = tpresets.volpath_scene(**dict(kw, version=version))
        assert tvp.trace_fn(sc.static) is tvp.trace_volpath_final
        images.append(trender.render_samples(sc, tvp.trace_fn(sc.static), seed=SEED))
    np.testing.assert_array_equal(images[0], images[1])
    assert images[0].mean() > 0


def test_volpath_soa_matches_per_ray_hetero():
    """tests/test_volpath.py's check inside the port: the SoA render (seed
    3) and the per-ray final version (seed 4), 32 spp: means within 6%,
    blurred pixels within 20% at the 90th percentile."""
    sc = tpresets.volpath_scene(version=6, width=20, height=20, spp=32, max_depth=6,
                                hetero=True, with_diffuse_sphere=True)
    assert tvsoa.supports_soa_volpath(sc)
    a = tvsoa.render_volpath_soa(sc, seed=3)
    b = trender.render_samples(sc, tvp.trace_fn(sc.static), spp=32, seed=4)
    assert np.isfinite(a).all() and (a >= 0).all()
    assert abs(a.mean() - b.mean()) / b.mean() < 0.06, (a.mean(), b.mean())
    ka = a.reshape(5, 4, 5, 4, 3).mean(axis=(1, 3))
    kb = b.reshape(5, 4, 5, 4, 3).mean(axis=(1, 3))
    rel = np.abs(ka - kb) / (kb + 2e-2)
    assert np.quantile(rel, 0.9) < 0.2, np.quantile(rel, 0.9)


def test_dispatch_takes_the_final_version(monkeypatch):
    sc = tpresets.volpath_scene(**dict(FINAL, width=8, height=8, spp=2))
    monkeypatch.setattr(tmsoa, "supports_soa_materials", lambda scene: False)
    assert not tvsoa.supports_soa_volpath(sc)
    img, rays = trender.render(sc, seed=SEED, device="cpu", return_stats=True)
    ref, ref_rays = trender.render_samples(sc, tvp.trace_volpath_final, seed=SEED,
                                           return_stats=True)
    np.testing.assert_array_equal(img, ref)
    assert rays == ref_rays


@pytest.mark.gpu
def test_cuda_final_version_matches_cpu():
    """The 32x32 scene through the final version on the card (K1) against
    the plain versions on the CPU, with equal ray counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gdpt_tpu_torch.scene.build import scene_to

    sc = tpresets.volpath_scene(**dict(FINAL, width=32, height=32, spp=2))
    a, ra = trender.render_samples(scene_to(sc, "cuda"), tvp.trace_volpath_final, seed=3,
                                   return_stats=True)
    b, rb = trender.render_samples(scene_to(sc, "cpu"), tvp.trace_volpath_final, seed=3,
                                   return_stats=True)
    gate(a, b, float(b.mean()))
    assert ra == rb
