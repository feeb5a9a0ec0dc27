"""The port's sharded renders (parallel/sharding.py, the renderers'
mesh=) against gdpt_tpu's, on the CPU.

torch has one CPU device, so the port's mesh names it eight times
([cpu] * 8): the rays of every pass are padded and split into eight
contiguous shards, each cast on its own, and the sums joined in shard
order, as on eight cards. The reference runs on the conftest's eight
virtual CPU devices (sharding.make_mesh(jax.devices()[:8])), its test
scenes and seeds (tests/test_soa.py:146, :346-386).

Gates: port against reference at the path gate (at least 99% of values
within rtol 1e-3 / atol 1e-4, the mean within 0.1%), and the gradpath
render also at the reference's own sharded gate (rtol 2e-4, atol 1e-5);
ray counts equal to the reference's, padded lanes included (path and
volpath count the rays their padded lanes trace; gradpath scales a
band's count by its share of real lanes). Within the port, a sharded
render equals its unsharded banded render bit for bit (each lane's
arithmetic is the same, whichever shard it rides in), and a sharded
render resumed from a checkpoint equals the uninterrupted one.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import gdpt_soa as tgdpt
from gdpt_tpu_torch.integrators import path as tpath_ray
from gdpt_tpu_torch.integrators import path_soa as tpath
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.integrators import volpath_soa as tvol
from gdpt_tpu_torch.parallel import sharding as tsh
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import gate

CPU8 = [torch.device("cpu")] * 8
_CACHE = {}


def _scene(presets, kind):
    if kind == "samples":
        return presets.cornell_box(width=16, height=16, spp=8, max_depth=3)
    if kind == "path":
        return presets.cornell_box(width=16, height=16, spp=4, max_depth=3)
    if kind == "gradpath":
        return presets.cornell_box(width=16, height=16, spp=2, max_depth=3,
                                   integrator="gradpath", force_bvh=True)
    return presets.volpath_scene(version=6, width=16, height=16, spp=2, max_depth=4,
                                 hetero=True)


SEEDS = {"samples": 11, "path": 3, "gradpath": 9, "volpath": 4}


def _reference(kind):
    """(image, rays or None) of gdpt_tpu's sharded render on 8 devices."""
    if kind not in _CACHE:
        import jax
        from gdpt_tpu.integrators import path as jpath_ray
        from gdpt_tpu.parallel import sharding as jsh
        from gdpt_tpu.scene import presets as jpresets

        mesh = jsh.make_mesh(jax.devices()[:8])
        scene, seed = _scene(jpresets, kind), SEEDS[kind]
        if kind == "samples":
            out = (jsh.render_samples_sharded(scene, jpath_ray.trace_path, mesh, spp=8,
                                              seed=seed), None)
        else:
            fn = {"path": jsh.render_soa_sharded, "gradpath": jsh.render_gradpath_soa_sharded,
                  "volpath": jsh.render_volpath_soa_sharded}[kind]
            out = fn(scene, mesh, seed=seed, return_stats=True)
        _CACHE[kind] = (np.asarray(out[0]), out[1])
    return _CACHE[kind]


def _port(kind, mesh=CPU8, **kw):
    """(image, rays) of the port's render, sharded over `mesh` or, with
    mesh=None, unsharded through the banded loop."""
    scene, seed = _scene(tpresets, kind), SEEDS[kind]
    m = None if mesh is None else tsh.make_mesh(mesh)
    if kind == "samples":
        if m is None:
            return trender.render_samples(scene, tpath_ray.trace_path, spp=8, seed=seed,
                                          return_stats=True)
        return tsh.render_samples_sharded(scene, tpath_ray.trace_path, m, spp=8, seed=seed,
                                          return_stats=True)
    if m is None:
        fn = {"path": tpath.render_soa, "gradpath": tgdpt.render_gradpath_soa,
              "volpath": tvol.render_volpath_soa}[kind]
        return fn(scene, seed=seed, return_stats=True, wavefront=False, **kw)
    fn = {"path": tsh.render_soa_sharded, "gradpath": tsh.render_gradpath_soa_sharded,
          "volpath": tsh.render_volpath_soa_sharded}[kind]
    return fn(scene, m, seed=seed, return_stats=True, **kw)


def _cached_port(kind, mesh_name):
    key = ("port", kind, mesh_name)
    if key not in _CACHE:
        _CACHE[key] = _port(kind, mesh={"cpu8": CPU8, "banded": None}[mesh_name])
    return _CACHE[key]


KINDS = ["samples", "path", "gradpath", "volpath"]


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_render_matches_reference(kind):
    ref, ref_rays = _reference(kind)
    img, rays = _cached_port(kind, "cpu8")
    gate(img, ref, float(ref.mean()))
    if kind == "gradpath":
        np.testing.assert_allclose(img, ref, rtol=2e-4, atol=1e-5)
    if ref_rays is not None:
        assert rays == ref_rays


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_render_equals_unsharded_banded_render(kind):
    """Bit for bit. The ray count of path and volpath adds the rays of
    the 768 padded lanes (256 pixels padded to 8 x 128), gradpath's is
    scaled back to the real lanes, render_samples pads nothing here."""
    img, rays = _cached_port(kind, "cpu8")
    one, one_rays = _cached_port(kind, "banded")
    np.testing.assert_array_equal(img, one)
    if kind in ("path", "volpath"):
        assert rays > one_rays
    elif kind == "samples":
        assert rays == one_rays


@pytest.mark.parametrize("kind", ["path", "volpath"])
def test_a_mesh_that_needs_no_padding_counts_the_unsharded_rays(kind):
    """One CPU entry: 256 pixels are two whole 128-lane groups, so no lane
    is padded and the ray count is the unsharded render's."""
    img, rays = _port(kind, mesh=[torch.device("cpu")])
    one, one_rays = _cached_port(kind, "banded")
    np.testing.assert_array_equal(img, one)
    assert rays == one_rays


def test_render_samples_sharded_pads_to_the_mesh():
    """10x10 pixels over 8 entries: 4 padded lanes (pixel 0), dropped
    from the image; two sample shards of 4 samples each."""
    scene = tpresets.cornell_box(width=10, height=10, spp=8, max_depth=3)
    m = tsh.make_mesh(CPU8)
    assert tsh.ray_pad(m, 100, align=1) == 4 and tsh.ray_pad(m, 100) == 924
    img, rays = tsh.render_samples_sharded(scene, tpath_ray.trace_path, m, seed=2,
                                           sample_shards=2, return_stats=True)
    one, one_rays = trender.render_samples(scene, tpath_ray.trace_path, seed=2,
                                           return_stats=True)
    assert img.shape == (10, 10, 3) and rays > one_rays
    np.testing.assert_allclose(img, one, rtol=0, atol=1e-6)  # 4 + 4 samples vs 8 in f32


def test_sharded_gradpath_bands(monkeypatch):
    """A BVH gradpath image above PIX_CAP pixels goes through in bands;
    sharded, every band is padded to the first band's width and then to
    whole 128-lane groups per device (the reference's band_args), and
    its ray count is scaled by its share of real lanes: 256 pixels in
    three bands of 86, 86 and 84."""
    monkeypatch.setattr(tgdpt, "PIX_CAP", 100)
    scene = _scene(tpresets, "gradpath")
    one, one_rays = tgdpt.render_gradpath_soa(scene, seed=9, wavefront=False,
                                              return_stats=True)
    got, rays = tsh.render_gradpath_soa_sharded(scene, tsh.make_mesh(CPU8), seed=9,
                                                return_stats=True)
    np.testing.assert_array_equal(got, one)
    assert np.array_equal(got, _cached_port("gradpath", "banded")[0])
    # The reference's count: each band's padded lanes (pixel 0 past its
    # real ones) traced on one device, scaled by m / 1,024.
    sc = tpath.scene_soa_from_aos(scene)
    expect = 0.0
    for sample in range(2):
        for lo, hi in ((0, 86), (86, 172), (172, 256)):
            idx = torch.from_numpy(np.pad(np.arange(lo, hi), (0, 1024 - (hi - lo))))
            _, nr = tgdpt._gdpt_pass(scene.static, scene.device.camera, sc, idx, idx, idx, 9,
                                     sample, 1)
            expect += float(nr) * (hi - lo) / 1024
    assert rays == expect and rays != one_rays


@pytest.mark.parametrize("kind", ["path", "gradpath"])
def test_sharded_resume_equals_uninterrupted(kind):
    """start_sample / init_acc under mesh=: the second sample resumed from
    the first one's checkpoint. The BVH gradpath box casts one sample a
    pass, so the resume is bit for bit; the brute-force path box sums
    both samples of its one pass in f32 first (atol 1e-6)."""
    m = tsh.make_mesh(CPU8)
    kept = []
    scene = _scene(tpresets, kind)
    render = tpath.render_soa if kind == "path" else tgdpt.render_gradpath_soa
    straight = render(scene, spp=2, seed=7, mesh=m)
    render(scene, spp=1, seed=7, mesh=m, on_chunk=lambda acc, done: kept.append(acc.copy()))
    got = render(scene, spp=2, seed=7, mesh=m, start_sample=1, init_acc=kept[-1])
    if kind == "gradpath":
        np.testing.assert_array_equal(got, straight)
    else:
        np.testing.assert_allclose(got, straight, rtol=0, atol=1e-6)


def test_make_mesh(monkeypatch):
    """make_mesh() takes every CUDA device and raises without one; CPU
    devices are used only when named, and may repeat."""
    m = tsh.make_mesh(["cpu"] * 3)
    assert m.devices == (torch.device("cpu"),) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.make_mesh()
    with pytest.raises(ValueError):
        tsh.make_mesh([])


@pytest.mark.parametrize("kind", ["path", "gradpath", "volpath"])
def test_mesh_with_wavefront_raises(kind):
    """A sharded render takes the banded loop; wavefront=True with a mesh
    raises instead of quietly running banded."""
    with pytest.raises(ValueError, match="banded"):
        _port(kind, wavefront=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_sharded_render_equals_unsharded(kind):
    """A mesh of cuda:0 four times against the unsharded banded render on
    the card, bit for bit, and the 16x16 renders against the CPU's at the
    path gate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gdpt_tpu_torch.scene.build import scene_to

    scene, seed = scene_to(_scene(tpresets, kind), "cuda"), SEEDS[kind]
    m = tsh.make_mesh(["cuda"] * 4)
    if kind == "samples":
        img = tsh.render_samples_sharded(scene, tpath_ray.trace_path, m, spp=8, seed=seed)
        one = trender.render_samples(scene, tpath_ray.trace_path, spp=8, seed=seed)
    else:
        fn = {"path": tpath.render_soa, "gradpath": tgdpt.render_gradpath_soa,
              "volpath": tvol.render_volpath_soa}[kind]
        img, one = fn(scene, seed=seed, mesh=m), fn(scene, seed=seed, wavefront=False)
    np.testing.assert_array_equal(img, one)
    cpu = _cached_port(kind, "cpu8")[0]
    gate(img, cpu, float(cpu.mean()))
