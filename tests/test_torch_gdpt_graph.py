"""The banded gradpath pass's sample replayed as a CUDA graph
(gdpt_soa._gdpt_pass over banded.sample_pass).

On the CPU: trace_gdpt_soa with its seed and sample index as 0-d int64
tensors gives the Python-int call's six buffers and ray count bit for
bit; at max_depth > 0 its fixed trip count gives the while loop's bits,
whether a lane reaches the depth cap or every lane retires before it;
the sample takes no host read and makes no copy from the host, which a
capture would refuse (the route's rule and the graph-share reader are
test_torch_path_graph's, for both integrators). On the card (`gpu`): a
graphed render_gradpath_soa equals an eager sum bit for bit, aux
buffers and rays too; a path graph and a gradpath graph of one view and
lane count are two memo entries; and each graph's capture tallies an
eager sample's K1 and K2 launches.
"""

import numpy as np
import pytest
import torch
from test_torch_path_graph import SEEDS, _HostTraffic, _lanes

from gdpt_tpu_torch.accel import brute_kernels
from gdpt_tpu_torch.integrators import banded, gdpt_soa, path_soa
from gdpt_tpu_torch.scene import presets
from gdpt_tpu_torch.scene.build import scene_to


def _box(w, h, depth=6, **kw):
    return presets.cornell_box(w, h, spp=1, integrator="gradpath", max_depth=depth, **kw)


def _sampler(scene, device):
    """trace_gdpt_soa(seed, sample0) over every pixel of `scene`'s film,
    as (the 18 buffer components, rays)."""
    sd = scene_to(scene, device)
    sc = path_soa.scene_soa_from_aos(sd)
    lanes = _lanes(scene.static.width, scene.static.height, device)

    def sample(seed, sample0):
        out, rays = gdpt_soa.trace_gdpt_soa(scene.static, sd.device.camera, sc, *lanes, seed,
                                            sample0)
        return [c for buf in out for c in buf], rays
    return sample


def _while_loop(scene, seed, sample0):
    """The sample as the eager loop ran it before the fixed trip count:
    bounces until no lane is active. Returns (components, rays)."""
    st = scene.static
    sc = path_soa.scene_soa_from_aos(scene)
    n = st.width * st.height
    pixel = torch.arange(n)
    lanes = gdpt_soa._init_gdpt_lanes(st, scene.device.camera, sc, pixel,
                                      torch.full((n,), sample0), seed,
                                      torch.ones(n, dtype=torch.bool))
    lanes["rays"] = torch.tensor(5.0 * n)
    while bool((lanes["active"] > 0).any()):
        lanes = gdpt_soa._gdpt_bounce(st, sc, st.used_material_kinds, seed, lanes)
    bufs = (lanes["radiance"], lanes["primal_bf"], *lanes["diffs"])
    return [c for buf in bufs for c in buf], lanes["rays"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("depth", (6, -1))
def test_tensor_seed_and_sample_give_the_int_calls_bits(depth, seed):
    """A 16x16 gradient-domain Cornell box: seed and sample0 as 0-d int64
    tensors against Python ints, the six buffers and rays bit for bit."""
    sample = _sampler(_box(16, 16, depth), "cpu")
    r, nr = sample(seed & 0xFFFFFFFF, 5)
    rt, nrt = sample(torch.tensor(seed & 0xFFFFFFFF), torch.tensor(5))
    assert len(r) == 18
    for a, b in zip((*r, nr), (*rt, nrt)):
        assert torch.equal(a, b)
    assert float(nr) > 5 * 256


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("film,depth", [((16, 16), 6), ((4, 4), 32)])
def test_the_fixed_trip_count_gives_the_while_loops_bits(film, depth, seed):
    """At max_depth > 0 trace_gdpt_soa runs n_iters + 1 bounces, as
    gdpt_soa.work counts them, and equals the while loop bit for bit
    (zeros equal whatever their sign). The 16x16 box at depth 6 keeps a
    lane to the cap, so the while loop runs as many bounces; on the 4x4
    box at depth 32 roulette retires every lane long before the cap of
    33, and the extra bounces over retired lanes add nothing."""
    scene = scene_to(_box(*film, depth), "cpu")
    cap = gdpt_soa._n_iters(scene.static) + 1
    before = gdpt_soa.WORK["bounces"]
    got, rays = _sampler(scene, "cpu")(seed & 0xFFFFFFFF, 2)
    assert gdpt_soa.WORK["bounces"] - before == cap
    before = gdpt_soa.WORK["bounces"]
    ref, ref_rays = _while_loop(scene, seed & 0xFFFFFFFF, 2)
    ran = gdpt_soa.WORK["bounces"] - before
    assert ran == cap if depth == 6 else ran < cap // 2
    assert torch.equal(rays, ref_rays)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("box", ("cornell", "material"))
def test_a_graphed_gdpt_sample_reads_nothing_back(box):
    """The sample a graphed gradpath pass captures (_add_gdpt_sample), on
    CPU lanes: no operation that a capture refuses, for the Cornell box
    and the brute-force material box (every material kind, image
    textures, an image envmap; the replay shift runs). A second call, as
    a capture follows the warm call, so memoised constants are made
    before it."""
    scene = (_box(16, 16) if box == "cornell" else
             presets.material_box(16, 16, 1, integrator="gradpath", max_depth=8, image_px=16,
                                  env_px=8))
    assert scene.static.use_brute_force and scene.static.options.max_depth > 0
    sd = scene_to(scene, "cpu")
    sc = path_soa.scene_soa_from_aos(sd)
    lanes = _lanes(16, 16, "cpu")
    acc = torch.zeros((18, 256))
    rays = torch.zeros(())
    seed, sample0 = torch.tensor(11), torch.tensor(2)

    def sample():
        gdpt_soa._add_gdpt_sample(scene.static, sd.device.camera, sc, lanes, seed, sample0,
                                  acc, rays)

    sample()
    with _HostTraffic() as mode:
        sample()
    assert not mode.seen, dict(mode.seen)
    assert float(rays) > 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _eager_gradpath(scene, spp, seed):
    """render_gradpath_soa's reconstruction, aux buffers and rays from a
    plain sum of trace_gdpt_soa on the card (one pass: the samples summed
    in f32 in order, then in float64 on the host, then the solve)."""
    st = scene.static
    sd = scene_to(scene, "cuda")
    sc = path_soa.scene_soa_from_aos(sd)
    n = st.width * st.height
    lanes = _lanes(st.width, st.height, torch.device("cuda"))
    acc = torch.zeros((18, n), device="cuda")
    rays = torch.zeros((), device="cuda")
    for i in range(spp):
        gdpt_soa._add_gdpt_sample(st, sd.device.camera, sc, lanes, seed, i, acc, rays)
    host = acc.cpu().numpy().astype(np.float64).reshape(6, 3, n)
    return gdpt_soa._gdpt_finish(st, host, spp, st.width, st.height, float(rays), True, True,
                                 torch.device("cuda"))


def _same(got, ref):
    (img, aux, rays), (ref_img, ref_aux, ref_rays) = got, ref
    assert np.array_equal(img, ref_img) and rays == ref_rays
    assert aux.keys() == ref_aux.keys()
    for k in aux:
        assert np.array_equal(aux[k], ref_aux[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("film,spp", [((64, 64), 2), ((32, 48), 4)])
def test_graphed_render_equals_the_eager_sum(film, spp, seed):
    """The gradient-domain box at depth 6: render_gradpath_soa replays its
    captured sample and equals the eager sum bit for bit (the
    reconstruction, the primal, brute-force primal and gradient images,
    the rays), whichever seed and sample index the graph is handed."""
    _card()
    scene = scene_to(_box(*film), "cuda")
    before = dict(gdpt_soa.GRAPHS)
    got = gdpt_soa.render_gradpath_soa(scene, spp=spp, seed=seed, return_aux=True,
                                       return_stats=True)
    assert gdpt_soa.GRAPHS["replayed"] == before["replayed"] + spp
    assert gdpt_soa.GRAPHS["eager"] == before["eager"]
    _same(got, _eager_gradpath(scene, spp, seed & 0xFFFFFFFF))


@pytest.mark.gpu
def test_path_and_gradpath_graphs_keep_apart():
    """One scene's view and lane count rendered by render_soa and by
    render_gradpath_soa: each captures its own graph under its own memo
    key, once, and each image keeps its eager sum's bits afterwards."""
    _card()
    from test_torch_path_graph import _eager_image

    scene = scene_to(_box(32, 32), "cuda")
    sc = path_soa.scene_soa_from_aos(scene)
    keys = lambda: {k for k in banded._GRAPH_MEMO.entries if k[0] == id(sc)}  # noqa: E731
    path_before, gdpt_before = path_soa.GRAPHS["captured"], gdpt_soa.GRAPHS["captured"]
    for _ in range(2):
        img = path_soa.render_soa(scene, spp=1, seed=8)
        got = gdpt_soa.render_gradpath_soa(scene, spp=1, seed=8, return_aux=True,
                                           return_stats=True)
        assert np.array_equal(img, _eager_image(scene, 1, 8)[0])
        _same(got, _eager_gradpath(scene, 1, 8))
    assert path_soa.GRAPHS["captured"] == path_before + 1
    assert gdpt_soa.GRAPHS["captured"] == gdpt_before + 1
    samples = {k[1][0] for k in keys()}
    assert {path_soa._add_fused_sample, gdpt_soa._add_gdpt_sample} <= samples


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("path", "gradpath"))
def test_a_capture_tallies_an_eager_samples_casts(kind):
    """The K1 and K2 launches a graph's capture tallies, and so counts per
    replay, are those of one eager sample of the same integrator on the
    same lanes (a 64x64 box at depth 6)."""
    _card()
    scene = scene_to(_box(64, 64), "cuda")
    st, sc = scene.static, path_soa.scene_soa_from_aos(scene)
    add, rows = ((path_soa._add_sample, 3) if kind == "path" else
                 (gdpt_soa._add_gdpt_sample, 18))
    lanes = _lanes(64, 64, torch.device("cuda"))
    before = dict(brute_kernels.LAUNCHES)
    add(st, scene.device.camera, sc, lanes, 3, 0, torch.zeros((rows, 64 * 64), device="cuda"),
        torch.zeros((), device="cuda"))
    eager = {k: brute_kernels.LAUNCHES[k] - before[k] for k in before}
    counts = {"captured": 0, "replayed": 0, "eager": 0}
    with torch.cuda.device(lanes[0].device):
        g = banded._SampleGraph(add, rows, counts, st, scene.device.camera, sc, *lanes)
    assert g.launches == eager and eager["intersect"] > 0 and eager["occluded"] > 0
    before = dict(brute_kernels.LAUNCHES)
    g.run(*lanes, 3, 0, 2)
    assert {k: brute_kernels.LAUNCHES[k] - before[k] for k in before} == \
        {k: 2 * v for k, v in eager.items()}
