"""The path integrator's fused stages (integrators/path_fused.py).

On the CPU: the envelope (path_fused.supports) takes brute-force
Lambertian scenes lit by mesh lights on CUDA lanes and nothing else; the
plain stages give trace_paths_soa's bits, on the Cornell box at a fixed
and an unbounded depth and on a box dressed with vertex normals, uvs and
checkerboards under each filter and either RNG; the counter group
path_soa.fused counts eager samples as fused inside the envelope and as
plain outside it, and the benchmark's integrator.fused_share reads it.
On the card (`gpu`): each kernel stage equals its plain stage on the same
state; a sample equals trace_paths_soa's; graphed frames equal the
PyTorch route's; a replay renders the seed it is handed; a captured
sample holds six closest-hit and five shadow casts; the benchmark's
preview cell reads a fused share of one and is correct.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import banded, path_fused, path_soa
from gdpt_tpu_torch.scene import build, filters, presets
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene.build import scene_to

SEEDS = (3, 2 ** 32 - 5)


def _lanes(w, h, device):
    ys, xs = np.mgrid[0:h, 0:w]
    return (torch.as_tensor(xs.ravel().astype(np.float32), device=device),
            torch.as_tensor(ys.ravel().astype(np.float32), device=device),
            torch.arange(w * h, device=device))


def _cbox_with(w=16, h=16, depth=6, shapes=(), lights=(), materials=None):
    parts = presets.cornell_box_parts(w, h, 1, "path", depth)
    return build.build_scene(**{**parts, "shapes": parts["shapes"] + list(shapes),
                                "lights": parts["lights"] + list(lights),
                                "materials": materials or parts["materials"]})


def dressed_box(w, h, depth, filter_kind=filters.FILTER_GAUSSIAN, filter_param=0.5):
    """The Cornell box with vertex normals on the tall block and the light,
    uvs on both blocks and the light, and checkerboard reflectances on the
    white and red walls, under the given pixel filter."""
    parts = presets.cornell_box_parts(w, h, 1, "path", depth)
    rng = np.random.default_rng(5)
    shapes = list(parts["shapes"])
    for k in (5, 6, 7):
        nv = shapes[k].positions.shape[0]
        kw = {"uvs": rng.uniform(-1, 2, size=(nv, 2))}
        if k != 5:
            kw["normals"] = rng.normal(size=(nv, 3)) * 0.3 + (0, -1.0 if k == 7 else 0, 0)
        shapes[k] = dataclasses.replace(shapes[k], **kw)
    mats = list(parts["materials"])
    mats[0] = M.Lambertian(M.CheckerboardTexture(presets.WHITE, presets.RED, uscale=5.0,
                                                 vscale=5.0))
    mats[1] = M.Lambertian(M.CheckerboardTexture(presets.RED, presets.GREEN, uscale=3.0,
                                                 vscale=2.0, uoffset=0.25))
    cam = dataclasses.replace(parts["camera"], filter_kind=filter_kind, filter_param=filter_param)
    return build.build_scene(**{**parts, "shapes": shapes, "materials": mats, "camera": cam})


ENVELOPE = {
    "cbox": (lambda: presets.cornell_box(16, 16, spp=1, max_depth=6), "cuda", True),
    "dressed box": (lambda: dressed_box(16, 16, 6), "cuda", True),
    "cbox on cpu lanes": (lambda: presets.cornell_box(16, 16, spp=1, max_depth=6), "cpu",
                          False),
    "a sphere": (lambda: _cbox_with(shapes=[M.Sphere(np.array([278.0, 80, 200]), 80.0, 0)]),
                 "cuda", False),
    "an envmap": (lambda: _cbox_with(lights=[M.Envmap(0.5)]), "cuda", False),
    "an image texture": (lambda: _cbox_with(materials=[
        M.Lambertian(M.ImageTexture(np.full((4, 4, 3), 0.5, np.float32))),
        *presets.cornell_box_parts()["materials"][1:]]), "cuda", False),
    "the material box": (lambda: presets.material_box(16, 16, 1, image_px=16, env_px=8),
                         "cuda", False),
    "the bvh cbox": (lambda: presets.cornell_box(16, 16, spp=1, max_depth=6, force_bvh=True),
                     "cuda", False),
}


@pytest.mark.parametrize("case", ENVELOPE)
def test_the_envelope(case):
    """The Cornell box, plain or dressed, on CUDA lanes is in; CPU lanes,
    a sphere, an envmap, an image texture, the material box (every
    material kind) and the BVH box are out."""
    make, device, inside = ENVELOPE[case]
    assert path_fused.supports(make().static, torch.device(device)) is inside


def _trace_both(scene, seed, sample0, device="cpu"):
    sd = scene_to(scene, device)
    sc = path_soa.scene_soa_from_aos(sd)
    lanes = _lanes(scene.static.width, scene.static.height, torch.device(device))
    args = (sd.static, sd.device.camera, sc, *lanes, seed, sample0)
    return path_soa.trace_paths_soa(*args), path_fused.trace_paths_fused(*args)


def _same_bits(a, b):
    """Equal bit for bit, NaNs included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _assert_same(ref, got):
    (r, nr), (f, nf) = ref, got
    for name, a, b in zip(("x", "y", "z", "rays"), (*r, nr), (*f, nf)):
        assert _same_bits(a, b), f"{name}: {int((a != b).sum())} lanes differ"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("depth", (6, -1))
def test_the_plain_stages_give_trace_paths_soas_bits(depth, seed):
    """A 32x32 Cornell box: trace_paths_fused on CPU lanes (the plain
    stages) against trace_paths_soa, radiance and rays bit for bit."""
    ref, got = _trace_both(presets.cornell_box(32, 32, spp=1, max_depth=depth), seed, 5)
    _assert_same(ref, got)
    assert float(ref[1].sum()) > 32 * 32 * 4


@pytest.mark.parametrize("rng", ("pcg3d", "threefry"))
@pytest.mark.parametrize("filt", [(filters.FILTER_GAUSSIAN, 0.5), (filters.FILTER_BOX, 1.0),
                                  (filters.FILTER_TENT, 2.0)])
def test_the_plain_stages_cover_the_dressed_box(filt, rng, monkeypatch):
    """The dressed box (shading normals, uvs, checkerboards) at 24x24,
    depth 5, under each filter and either RNG: the plain stages give
    trace_paths_soa's bits."""
    monkeypatch.setenv("GDPT_RNG", rng)
    _assert_same(*_trace_both(dressed_box(24, 24, 5, *filt), 7, 2))


def test_the_counter_counts_fused_and_plain_samples(monkeypatch):
    """An eager 8x8 render of 2 spp counts its 128 pixel samples as plain
    on CPU lanes, and as fused where the envelope takes CPU lanes too (the
    plain stages then run, with the same image); integrator.fused_share
    reads the counter: nothing before a sample, then fused / all."""
    from benchmark.harness import spec

    reader = spec.load_module("metrics", "integrator.fused_share")
    for k in path_soa.FUSED:
        monkeypatch.setitem(path_soa.FUSED, k, 0)
    assert reader.read(None) is None
    scene = presets.cornell_box(8, 8, spp=2, max_depth=6)
    plain = path_soa.render_soa(scene, spp=2, seed=4)
    assert path_soa.FUSED == {"fused": 0, "plain": 128}
    assert reader.read(None) == 0.0
    supports = path_fused.supports
    monkeypatch.setattr(path_fused, "supports", lambda static, device: supports(static, "cuda"))
    fused = path_soa.render_soa(scene, spp=2, seed=4)
    assert path_soa.FUSED == {"fused": 128, "plain": 128}
    assert reader.read(None) == 0.5
    np.testing.assert_array_equal(fused, plain)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


CARD_SCENES = {
    "cbox 512": lambda: presets.cornell_box(512, 512, spp=1, max_depth=6),
    "dressed gaussian": lambda: dressed_box(128, 128, 6),
    "dressed box filter": lambda: dressed_box(128, 128, 7, filters.FILTER_BOX, 1.0),
    "dressed tent": lambda: dressed_box(128, 128, 4, filters.FILTER_TENT, 2.0),
}


def _diff(a, b):
    rows = [(r, int((a[r].view(torch.int32) != b[r].view(torch.int32)).sum()))
            for r in range(a.shape[0])]
    rows = [(r, k) for r, k in rows if k]
    if not rows:
        return ""
    r = rows[0][0]
    i = int((a[r].view(torch.int32) != b[r].view(torch.int32)).nonzero()[0])
    return f"rows (row, lanes) {rows}; row {r} lane {i}: {float(a[r, i])!r} vs {float(b[r, i])!r}"


@pytest.mark.gpu
@pytest.mark.parametrize("rng", ("pcg3d", "threefry"))
@pytest.mark.parametrize("case", CARD_SCENES)
def test_each_kernel_stage_equals_its_plain_stage(case, rng, monkeypatch):
    """Every stage of a sample on the card, from the same state: the
    kernel against its plain version, the whole (31, n) state bit for bit
    (262,144 lanes for the 512x512 box)."""
    _card()
    monkeypatch.setenv("GDPT_RNG", rng)
    sd = scene_to(CARD_SCENES[case](), "cuda")
    static, cam = sd.static, sd.device.camera
    sc = path_soa.scene_soa_from_aos(sd)
    lanes = _lanes(static.width, static.height, torch.device("cuda"))
    st = torch.zeros((path_fused.N_ROWS, lanes[0].shape[0]), device="cuda")
    seed, sample0 = 0x9E3779B9, 3
    stages = []

    def both(name, plain, kernel, *args):
        a, b = st.clone(), st.clone()
        plain(static, cam, sc, a, lanes, seed, sample0, *args)
        kernel(path_fused._Launch(static, cam, sc, b, lanes, seed, sample0), *args)
        torch.cuda.synchronize()
        assert _same_bits(a, b), f"{name}: {_diff(a, b)}"
        st.copy_(a)
        stages.append(name)

    for name, k, args in path_fused.schedule(static, sc, st):
        both(name, path_fused.PLAIN[k], path_fused.KERNELS[k], *args)
    n_iters = static.options.max_depth - 1
    assert len(stages) == 2 * n_iters + 2
    assert float(st[path_fused.ROWS["rays"]].sum()) > st.shape[1] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("case,depth", [("cbox 512", 6), ("cbox 512", -1),
                                        ("dressed gaussian", 6), ("dressed tent", -1)])
def test_a_sample_equals_trace_paths_soas(case, depth):
    """trace_paths_fused's kernels against trace_paths_soa on the card,
    radiance and rays bit for bit, at a fixed and an unbounded depth."""
    _card()
    scene = CARD_SCENES[case]()
    scene = scene._replace(static=dataclasses.replace(
        scene.static, options=dataclasses.replace(scene.static.options, max_depth=depth)))
    for seed in SEEDS:
        _assert_same(*_trace_both(scene, seed, 11, "cuda"))


def _eager_image(scene, trace, spp, seed):
    """render_soa's image and rays from a plain sum of `trace`'s samples
    on the card (the samples summed in f32 in order, then in float64)."""
    st = scene.static
    sd = scene_to(scene, "cuda")
    sc = path_soa.scene_soa_from_aos(sd)
    lanes = _lanes(st.width, st.height, torch.device("cuda"))
    acc = [torch.zeros_like(lanes[0]) for _ in range(3)]
    rays = torch.zeros((), dtype=torch.float32, device="cuda")
    for i in range(spp):
        r, nr = trace(st, sd.device.camera, sc, *lanes, seed, i)
        acc = [a + c for a, c in zip(acc, r)]
        rays = rays + nr.sum()
    host = np.stack([a.cpu().numpy().astype(np.float64) for a in acc])
    img = (host / spp).T.reshape(st.height, st.width, 3).astype(np.float32)
    return np.where(np.isfinite(img), img, 0.0), float(rays)


@pytest.mark.gpu
@pytest.mark.parametrize("spp", (1, 3, 256))
def test_graphed_frames_equal_the_pytorch_route(spp, monkeypatch):
    """512x512 Cornell box frames at depth 6 (preview frames of 1 and 3
    spp, a 256-spp band in one pass): the fused route's replays against
    the PyTorch route's (the envelope closed), image and rays bit for bit;
    each captures its own graph, and the counter says which ran."""
    _card()
    a = scene_to(presets.cornell_box(512, 512, spp=spp, max_depth=6), "cuda")
    b = scene_to(presets.cornell_box(512, 512, spp=spp, max_depth=6), "cuda")
    before, captured = dict(path_soa.FUSED), path_soa.GRAPHS["captured"]
    img, rays = path_soa.render_soa(a, spp=spp, seed=12, return_stats=True)
    assert path_soa.FUSED["fused"] == before["fused"] + 512 * 512 * spp
    monkeypatch.setattr(path_fused, "supports", lambda static, device: False)
    ref, ref_rays = path_soa.render_soa(b, spp=spp, seed=12, return_stats=True)
    assert path_soa.FUSED["plain"] == before["plain"] + 512 * 512 * spp
    assert path_soa.GRAPHS["captured"] == captured + 2
    assert np.array_equal(img, ref) and rays == ref_rays


@pytest.mark.gpu
def test_a_replay_renders_the_seed_it_is_handed():
    """A 64x64 box captured at one seed, then replayed at others: each
    image equals that seed's eager sum of trace_paths_fused and of
    trace_paths_soa."""
    _card()
    scene = scene_to(presets.cornell_box(64, 64, spp=2, max_depth=6), "cuda")
    path_soa.render_soa(scene, spp=2, seed=1)
    captured = path_soa.GRAPHS["captured"]
    for seed in (2, 0x9E3779B9):
        img, rays = path_soa.render_soa(scene, spp=2, seed=seed, return_stats=True)
        for trace in (path_fused.trace_paths_fused, path_soa.trace_paths_soa):
            ref, ref_rays = _eager_image(scene, trace, 2, seed)
            assert np.array_equal(img, ref) and rays == ref_rays
    assert path_soa.GRAPHS["captured"] == captured


@pytest.mark.gpu
def test_a_captured_sample_holds_the_casts_and_the_stages():
    """The first pass of a fresh box captures a sample of six K1 and five
    K2 casts and of one primary, six after_hit and five after_shadow
    kernels; path_fused.LAUNCHES counts the stages of the eager warm-up
    before the capture and of each replay, and none of the capture."""
    _card()
    scene = scene_to(presets.cornell_box(48, 48, spp=2, max_depth=6), "cuda")
    before = dict(path_fused.LAUNCHES)
    path_soa.render_soa(scene, spp=2, seed=3)
    sc = path_soa.scene_soa_from_aos(scene)
    graphs = [g for tree, g in banded._GRAPH_MEMO.entries.values() if tree is sc]
    assert len(graphs) == 1
    assert graphs[0].launches == {"intersect": 6, "occluded": 5}
    stages = {"primary": 1, "after_hit": 6, "after_shadow": 5}
    assert graphs[0].kernel_launches == stages
    delta = {k: path_fused.LAUNCHES[k] - before[k] for k in before}
    assert delta == {k: 3 * v for k, v in stages.items()}


@pytest.mark.gpu
def test_the_preview_cell_reads_a_fused_share_of_one(monkeypatch):
    """A short traced run of the benchmark's preview cell on the card at a
    64x64 film, counters zeroed as in a run's own process: its fused share
    is 1.0 and the run is correct."""
    _card()
    import io
    import time

    from benchmark.harness import session, spec

    for k in path_soa.FUSED:
        monkeypatch.setitem(path_soa.FUSED, k, 0)
    out, err = io.StringIO(), io.StringIO()
    res = session.run(spec.Cell(spec.load_spec(), "cbox_512_path.preview_1spp"), 2 ** 31 + 77,
                      1.0, True, time.perf_counter(), film=(64, 64), out=out, err=err)
    assert res["correct"], err.getvalue()
    assert res["metrics"]["integrator.fused_share"]["value"] == 1.0
