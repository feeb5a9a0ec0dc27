"""The port's per-ray volumetric rungs, versions 1-3 (integrators/volpath.py
through render.render_samples), against gdpt_tpu's on the CPU.

Each rung renders presets.volpath_scene (built with either package's own
modules by presets.build_volpath_scene) with the port and with the
reference's render_samples(scene, trace_fn(static)) at the same seed.
Their RNG streams are bit-identical (tests/test_torch_rng.py), so the
images are held pixel by pixel at the path gate of
tests/test_torch_volpath.py: at least 99% of values within rtol 1e-3 /
atol 1e-4, the mean within 0.1% (an ulp of a transcendental or of a hit
distance can flip a free-flight or Russian-roulette test). The
tests/test_volpath.py checks of these rungs are mirrored on the port's
renders: v1's closed form at the center pixel, v2's in-scattering in a
corner away from the lights.

The gpu-marked test renders v3 at 32x32 on the card and on the CPU and
holds them at the same gate with equal ray counts; this file imports jax
only inside the reference helpers, so it runs with --noconftest where
jax is absent.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.integrators import volpath as tvp
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import check_cuda_vs_cpu, gate

SEED = 7


def scene_pair(**kw):
    """(reference scene, port scene) of volpath_scene with keywords kw."""
    from gdpt_tpu.core import transform as jxf
    from gdpt_tpu.scene import build as jbuild
    from gdpt_tpu.scene import model as jmodel
    from gdpt_tpu_torch.core import transform as txf
    from gdpt_tpu_torch.scene import build as tbuild
    from gdpt_tpu_torch.scene import model as tmodel

    return (tpresets.build_volpath_scene(jmodel, jbuild, jxf, **kw),
            tpresets.build_volpath_scene(tmodel, tbuild, txf, **kw))


def reference_render(scene, seed, spp=None):
    from gdpt_tpu.integrators import render as jrender
    from gdpt_tpu.integrators import volpath as jvol

    return np.asarray(jrender.render_samples(scene, jvol.trace_fn(scene.static), spp=spp,
                                             seed=seed))


def check_rung(**kw):
    """Render both packages' scene of kw at SEED; gate the port's image
    against the reference's. Returns (port image, rays)."""
    js, ts = scene_pair(**kw)
    ja = reference_render(js, SEED)
    ta, rays = trender.render(ts, seed=SEED, device="cpu", return_stats=True)
    gate(ta, ja, float(ja.mean()))
    return ta, rays


RUNGS = {
    1: dict(version=1, width=20, height=20, spp=3),
    2: dict(version=2, width=20, height=20, spp=3, max_depth=3),
    3: dict(version=3, width=20, height=20, spp=3, max_depth=6),
    "3-deep": dict(version=3, width=16, height=16, spp=2, max_depth=-1, g=0.5,
                   with_diffuse_sphere=True),
}


@pytest.mark.parametrize("rung", list(RUNGS), ids=str)
def test_rung_matches_reference(rung):
    img, rays = check_rung(**RUNGS[rung])
    kw = RUNGS[rung]
    n = kw["width"] * kw["height"] * kw["spp"]
    if kw["version"] == 1:
        assert rays == n
    else:
        assert rays > n


def test_rays_count_live_lanes():
    """v2 casts one camera ray per lane and a shadow ray for the lanes
    that scatter before their hit; v3's bounce loop stops casting for
    lanes that died."""
    _, ts = scene_pair(**RUNGS[2])
    _, r2 = trender.render(ts, seed=SEED, device="cpu", return_stats=True)
    n = 20 * 20 * 3
    assert n < r2 < 2 * n
    for k in tvp.HOST_READS:
        tvp.HOST_READS[k] = 0
    _, ts = scene_pair(**RUNGS[3])
    _, r3 = trender.render(ts, seed=SEED, device="cpu", return_stats=True)
    reads = tvp.HOST_READS["bounce"]
    assert 2 <= reads <= 8  # depth 6: at most cap + 1 bodies, one more read to stop
    assert r3 < (reads - 1) * n


def test_v1_absorption_analytic():
    """Center ray: the camera at z=-3 hits the unit emissive sphere at
    distance 2; absorption-only transmittance is exp(-sigma_a * 2)."""
    sc = tpresets.volpath_scene(version=1, width=24, height=24, spp=4)
    img = trender.render(sc, seed=0, device="cpu")
    expected = np.exp(-0.1 * 2.0) * np.array([0.4, 2.32, 3.2])
    np.testing.assert_allclose(img[12, 12], expected, rtol=5e-3)


def test_v2_single_scatter_positive_outside_lights():
    sc = tpresets.volpath_scene(version=2, width=24, height=24, spp=32, max_depth=3)
    img = trender.render(sc, seed=1, device="cpu")
    assert np.isfinite(img).all()
    assert (img[0, -1] > 0).all()


def test_trace_fn_maps_6_and_0_to_the_final_version():
    """Versions 6 and 0 take the per-ray oracle trace_volpath_final, as the
    reference's trace_fn maps them; 1-5 their own rungs."""
    for version in (6, 0):
        sc = tpresets.volpath_scene(version=version, width=4, height=4, spp=1)
        assert tvp.trace_fn(sc.static) is tvp.trace_volpath_final
    for version in (1, 2, 3, 4, 5):
        sc = tpresets.volpath_scene(version=version, width=4, height=4, spp=1)
        assert tvp.trace_fn(sc.static) is getattr(tvp, f"trace_volpath_{version}")


@pytest.mark.gpu
def test_cuda_rung_matches_cpu():
    """v3 at 32x32 through K1 on the card against the plain versions on
    the CPU, with equal ray counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    check_cuda_vs_cpu(tpresets.volpath_scene(version=3, width=32, height=32, spp=2,
                                             max_depth=6, with_diffuse_sphere=True))
