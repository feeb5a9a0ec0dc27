"""The banded pass's sample replayed as a CUDA graph (path_soa._soa_pass
over banded.sample_pass).

On the CPU: trace_paths_soa with its seed and sample index as 0-d int64
tensors (the graph's inputs) gives the bits of the Python-int call; the
sample takes no host read and makes no copy from the host, which a
capture would refuse; and, for path and gradpath alike, the route's rule
(banded.graphed: CUDA lanes, brute-force casts, max_depth > 0) leaves
CPU lanes, the unbounded loop and BVH scenes eager, counted under
"eager" alone, and the benchmark's graph-share readers read those
counters. On the card (`gpu`): the graphed render equals an eager sum of
trace_paths_soa bit for bit, a new film or scene captures anew, a graph
outlives the memoised film size it read, a replayed frame under the
profiler records K1 and K2 and the frame after it keeps its bits, and
the benchmark's render.graph_share and gdpt.graph_share read 1.0 in
their cells.
"""

import collections
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gdpt_tpu_torch.integrators import banded, gdpt_soa, path_soa
from gdpt_tpu_torch.scene import presets
from gdpt_tpu_torch.scene.build import scene_to

SEEDS = (3, 0x9E3779B9, 2 ** 32 - 5)

# Each integrator's banded render, counter group of graphs and the
# benchmark's reader of that group.
RENDERS = {"path": (path_soa.render_soa, path_soa.GRAPHS, "render.graph_share"),
           "gradpath": (gdpt_soa.render_gradpath_soa, gdpt_soa.GRAPHS, "gdpt.graph_share")}


def _lanes(w, h, device):
    ys, xs = np.mgrid[0:h, 0:w]
    return (torch.as_tensor(xs.ravel().astype(np.float32), device=device),
            torch.as_tensor(ys.ravel().astype(np.float32), device=device),
            torch.arange(w * h, device=device))


def _sampler(scene, device):
    """trace_paths_soa(seed, sample0) over every pixel of `scene`'s film."""
    sd = scene_to(scene, device)
    sc = path_soa.scene_soa_from_aos(sd)
    lanes = _lanes(scene.static.width, scene.static.height, device)
    return lambda seed, sample0: path_soa.trace_paths_soa(scene.static, sd.device.camera, sc,
                                                          *lanes, seed, sample0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("depth", (6, -1))
def test_tensor_seed_and_sample_give_the_int_calls_bits(depth, seed):
    """A 16x16 Cornell box: seed and sample0 as 0-d int64 tensors against
    Python ints, radiance and rays bit for bit."""
    scene = presets.cornell_box(16, 16, spp=1, max_depth=depth)
    sample = _sampler(scene, "cpu")
    r, nr = sample(seed, 5)
    rt, nrt = sample(torch.tensor(seed & 0xFFFFFFFF), torch.tensor(5))
    for a, b in zip((*r, nr), (*rt, nrt)):
        assert torch.equal(a, b)
    assert float(nr.sum()) > 256


class _HostTraffic(TorchDispatchMode):
    """Counts the operations a captured stream refuses: reads of a
    tensor's value on the host, data-dependent shapes and tensors made
    from host data (a copy from the host that waits for the device)."""

    REFUSED = {"_local_scalar_dense", "nonzero", "masked_select", "unique", "lift_fresh",
               "lift_fresh_copy", "equal", "is_nonzero"}

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in self.REFUSED or (name == "_to_copy" and "device" in kwargs):
            self.seen[name] += 1
        return func(*args, **kwargs)


@pytest.mark.parametrize("box", ("cornell", "material"))
def test_a_graphed_sample_reads_nothing_back(box):
    """The sample a graphed pass captures, on CPU lanes: no operation that
    a capture refuses, for the Cornell box and the brute-force material
    box (every material kind, image textures, an image envmap). A second
    call, as a capture follows the warm call, so memoised constants are
    made before it."""
    scene = (presets.cornell_box(16, 16, spp=1, max_depth=6) if box == "cornell" else
             presets.material_box(16, 16, 1, max_depth=8, image_px=16, env_px=8))
    assert scene.static.use_brute_force and scene.static.options.max_depth > 0
    sample = _sampler(scene, "cpu")
    seed, sample0 = torch.tensor(11), torch.tensor(2)
    sample(seed, sample0)
    with _HostTraffic() as mode:
        sample(seed, sample0)
    assert not mode.seen, dict(mode.seen)


@pytest.mark.parametrize("kind", RENDERS)
def test_the_rule_leaves_eager_passes_eager(kind):
    """banded.graphed() on CUDA-like lanes takes brute force at a fixed
    depth only; renders on CPU lanes at depth 6, at depth -1 and of a BVH
    box (banded, and gradpath's wavefront pool) count their samples per
    pixel under their integrator's "eager" and capture and replay
    nothing."""
    render, graphs, _ = RENDERS[kind]
    cuda_like = SimpleNamespace(is_cuda=True)

    def box(depth, **kw):
        return presets.cornell_box(8, 8, spp=1, integrator=kind, max_depth=depth, **kw)

    brute6, brute_unbounded, bvh6, zero_depth = box(6), box(-1), box(6, force_bvh=True), box(0)
    assert not bvh6.static.use_brute_force
    assert banded.graphed(brute6.static, cuda_like)
    for scene in (brute_unbounded, bvh6, zero_depth):
        assert not banded.graphed(scene.static, cuda_like)
    assert not banded.graphed(brute6.static, torch.zeros(4))
    routes = [(brute6, False), (brute_unbounded, False), (bvh6, False)]
    if kind == "gradpath":
        routes.append((bvh6, True))
    for scene, wavefront in routes:
        before = dict(graphs)
        img = render(scene, spp=3, seed=4, wavefront=wavefront)
        assert np.isfinite(img).all()
        assert graphs == {**before, "eager": before["eager"] + 3}


@pytest.mark.parametrize("kind", RENDERS)
def test_the_graph_share_reader_reads_the_counter(kind, monkeypatch):
    """The benchmark's render.graph_share reads path_soa.graphs and
    gdpt.graph_share gdpt_soa.graphs: nothing before a sample has run,
    0.0 after an eager CPU render, the replayed share of all samples
    otherwise."""
    from benchmark.harness import spec

    render, graphs, metric = RENDERS[kind]
    reader = spec.load_module("metrics", metric)
    for k in graphs:
        monkeypatch.setitem(graphs, k, 0)
    assert reader.read(None) is None
    render(presets.cornell_box(8, 8, spp=1, integrator=kind, max_depth=6), spp=2, seed=1)
    assert reader.read(None) == 0.0
    monkeypatch.setitem(graphs, "replayed", 6)
    assert reader.read(None) == 0.75


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _eager_image(scene, spp, seed):
    """render_soa's image and rays from a plain sum of trace_paths_soa on
    the card (one pass: the samples summed in f32 in order, then in
    float64 on the host)."""
    st = scene.static
    sd = scene_to(scene, "cuda")
    sc = path_soa.scene_soa_from_aos(sd)
    lanes = _lanes(st.width, st.height, torch.device("cuda"))
    acc = [torch.zeros_like(lanes[0]) for _ in range(3)]
    rays = torch.zeros((), dtype=torch.float32, device="cuda")
    for i in range(spp):
        r, nr = path_soa.trace_paths_soa(st, sd.device.camera, sc, *lanes, seed, i)
        acc = [a + c for a, c in zip(acc, r)]
        rays = rays + nr.sum()
    host = np.stack([a.cpu().numpy().astype(np.float64) for a in acc])
    img = (host / spp).T.reshape(st.height, st.width, 3).astype(np.float32)
    return np.where(np.isfinite(img), img, 0.0), float(rays)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("spp", (1, 3))
def test_graphed_render_equals_the_eager_sum(spp, seed):
    """64x64 Cornell box at depth 6: render_soa replays its captured
    sample and equals the eager sum bit for bit, rays too, whichever seed
    and sample index the graph is handed."""
    _card()
    scene = scene_to(presets.cornell_box(64, 64, spp=spp, max_depth=6), "cuda")
    before = dict(path_soa.GRAPHS)
    img, rays = path_soa.render_soa(scene, spp=spp, seed=seed, return_stats=True)
    assert path_soa.GRAPHS["replayed"] == before["replayed"] + spp
    assert path_soa.GRAPHS["eager"] == before["eager"]
    ref, ref_rays = _eager_image(scene, spp, seed & 0xFFFFFFFF)
    assert np.array_equal(img, ref) and rays == ref_rays


@pytest.mark.gpu
def test_a_new_film_or_scene_captures_anew():
    """The same scene renders again without a capture; a second film and a
    second scene each capture once; each image equals its eager sum."""
    _card()
    a = presets.cornell_box(32, 32, spp=1, max_depth=6)
    cases = [(a, 1), (a, 0), (presets.cornell_box(48, 32, spp=1, max_depth=6), 1),
             (presets.cornell_box(32, 32, spp=1, max_depth=5), 1)]
    cases = [(scene_to(scene, "cuda"), captures) for scene, captures in cases]
    for scene, captures in cases:
        before = path_soa.GRAPHS["captured"]
        img = path_soa.render_soa(scene, spp=1, seed=9)
        assert path_soa.GRAPHS["captured"] == before + captures
        assert np.array_equal(img, _eager_image(scene, 1, 9)[0])


@pytest.mark.gpu
def test_a_graph_outlives_the_memos_it_read():
    """A graphed scene, then 17 eager samples of its view over other films
    on the card (more film sizes than primary_rays_soa's memo keeps; the
    scene's view and graph stay memoised), then the scene again: its
    graph still reads the film size it captured and the image keeps the
    eager sum's bits."""
    _card()
    scene = scene_to(presets.cornell_box(32, 32, spp=1, max_depth=6), "cuda")
    path_soa.render_soa(scene, spp=1, seed=5)
    captured = path_soa.GRAPHS["captured"]
    sc = path_soa.scene_soa_from_aos(scene)
    for i in range(17):
        film = dataclasses.replace(scene.static, width=8 + i, height=8)
        r, _ = path_soa.trace_paths_soa(film, scene.device.camera, sc,
                                        *_lanes(8 + i, 8, torch.device("cuda")), i, 0)
        assert all(bool(torch.isfinite(c).all()) for c in r)
    img = path_soa.render_soa(scene, spp=1, seed=6)
    assert path_soa.GRAPHS["captured"] == captured
    assert np.array_equal(img, _eager_image(scene, 1, 6)[0])


@pytest.mark.gpu
def test_replays_under_the_profiler_record_the_casts():
    """A replayed frame under a CPU + CUDA profiler session: the device
    records K1 and K2 inside the graph; the frames before and after the
    session keep the eager sum's bits."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    scene = scene_to(presets.cornell_box(64, 64, spp=1, max_depth=6), "cuda")
    path_soa.render_soa(scene, spp=1, seed=1)
    captured = path_soa.GRAPHS["captured"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = path_soa.render_soa(scene, spp=1, seed=2)
        torch.cuda.synchronize()
    names = collections.Counter(e.key for e in prof.key_averages()
                                if e.device_type == torch.autograd.DeviceType.CUDA)
    after = path_soa.render_soa(scene, spp=1, seed=3)
    assert path_soa.GRAPHS["captured"] == captured
    assert any("intersect_brute_kernel" in k for k in names), sorted(names)
    assert any("occluded_brute_kernel" in k for k in names), sorted(names)
    assert np.array_equal(traced, _eager_image(scene, 1, 2)[0])
    assert np.array_equal(after, _eager_image(scene, 1, 3)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,cell,seed", [("path", "cbox_512_path.preview_1spp", 77),
                                            ("gradpath", "cbox_512_gradpath.frames_4spp", 91)])
def test_the_benchmark_cell_reads_a_graph_share_of_one(kind, cell, seed, monkeypatch):
    """A short traced run of the benchmark's path and gradient-domain
    cells on the card, at a 64x64 film, with the counters zeroed as in a
    run's own process: the cell's graph share is 1.0 and the run is
    correct."""
    _card()
    _, graphs, metric = RENDERS[kind]
    for k in graphs:
        monkeypatch.setitem(graphs, k, 0)
    import io
    import time

    from benchmark.harness import session, spec

    out, err = io.StringIO(), io.StringIO()
    res = session.run(spec.Cell(spec.load_spec(), cell), 2 ** 31 + seed, 1.0, True,
                      time.perf_counter(), film=(64, 64), out=out, err=err)
    assert res["correct"], err.getvalue()
    assert res["metrics"][metric]["value"] == 1.0
