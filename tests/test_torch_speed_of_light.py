"""The port's speed-of-light tools (gdpt_tpu_torch/tools/speed_of_light.py,
wavefront_visits.py, fma_peak.py) against the reference's tools, on the
CPU.

The ray populations the ceilings are timed on must be the reference's
rays, or the two ceilings are not of the same work: on a 64x64 cbox (m =
4,096) the incoherent bbox-random rays equal tools/speed_of_light.py's bit
for bit, the camera rays' origins too, and the camera directions and the
harvested bounce and shadow rays (seed 9, streams 11-14, cut to whole
1,024s) agree at rtol 1e-5 / atol 1e-5 with equal counts (the Gaussian
filter's log, cos and sin differ by ulps between XLA and PyTorch).
capture_pool_rays on a level-2 icosphere box (16x16, a pool of 2,048
lanes, one warm chunk of 8 wavefront iterations) gives the reference's
post-regen rays lane by lane at rtol 1e-5 but for lanes whose path ended
in one package only and the queue shift they cause (see the test), and
_pool_shadow_rays on the reference's captured rays the same live shadow
count. fma_peak_plain equals numpy's per-step-rounded recurrence bit for
bit, and merge() replaces a config's row measured on another card.

The gpu-marked tests hold the FMA-peak kernel against its plain version
(rtol 1e-5; FMA and a float64 step round alike but for a rare double
rounding) and a chained cast (SOL_CHAIN_K casts in one CUDA graph) against
one eager cast, t and prim equal, for a brute-force and a packet scene:
    python -m pytest --noconftest -m gpu tests/test_torch_speed_of_light.py
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import path_soa as tps
from gdpt_tpu_torch.scene import presets as tpresets
from gdpt_tpu_torch.scene.build import scene_to
from gdpt_tpu_torch.tools import fma_peak as fp
from gdpt_tpu_torch.tools import speed_of_light as tsol
from gdpt_tpu_torch.tools import wavefront_visits as twv

from test_torch_bench import reference_script
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

M = 4096
POPULATIONS = ["coherent", "incoherent", "bounce", "shadow"]
_CACHE = {}


def _reference_tool(name):
    return reference_script(f"tools/{name}.py")


def _np(v3):
    return np.stack([np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c) for c in v3], 1)


def _populations():
    """{population: ((ref origins, ref dirs), (port origins, port dirs))}."""
    if "pops" not in _CACHE:
        from gdpt_tpu.integrators import path_soa as jps
        from gdpt_tpu.scene import presets as jpresets

        jsol = _reference_tool("speed_of_light")
        js = jpresets.cornell_box(64, 64, spp=1, max_depth=6)
        jsc = jps.scene_soa_from_aos(js)
        ts = scene_to(tpresets.cornell_box(64, 64, spp=1, max_depth=6), "cpu")
        tsc = tps.scene_soa_from_aos(ts)
        ref = dict(zip(POPULATIONS[:2], jsol._ray_batches(js, jsc, M)))
        ref.update(zip(POPULATIONS[2:], jsol._harvest_rays(js, jsc, M)))
        port = dict(zip(POPULATIONS[:2], tsol._ray_batches(ts, tsc, M)))
        port.update(zip(POPULATIONS[2:], tsol._harvest_rays(ts, tsc, M, out=lambda s: None)))
        _CACHE["pops"] = {k: ((_np(ref[k][0]), _np(ref[k][1])), (_np(port[k][0]),
                                                                  _np(port[k][1])))
                          for k in POPULATIONS}
    return _CACHE["pops"]


@pytest.mark.parametrize("population", POPULATIONS)
def test_ray_populations_match_reference(population):
    """The incoherent rays (numpy's generator) are the reference's bit for
    bit. The camera rays go through the Gaussian filter's Box-Muller,
    whose log, cos and sin XLA's CPU code and PyTorch compute a few ulps
    apart (33 of the 4,096 directions differ, by at most 1.2e-7), and the
    harvested rays start at those rays' hits: all of them are held at
    rtol 1e-5 / atol 1e-5, at most 0.1% of the rays outside it, with
    equal survivor counts."""
    (ro, rd), (to, td) = _populations()[population]
    assert ro.shape == to.shape and ro.dtype == to.dtype == np.float32
    assert ro.shape[0] % 1024 == 0 and ro.shape[0] <= M
    if population in ("coherent", "incoherent"):
        assert np.array_equal(ro.view(np.int32), to.view(np.int32))
    if population == "incoherent":
        assert np.array_equal(rd.view(np.int32), td.view(np.int32))
    for a, b in ((ro, to), (rd, td)):
        assert np.isclose(b, a, rtol=1e-5, atol=1e-5).all(axis=1).mean() >= 0.999
    assert np.abs(td - rd).max() <= 1e-5


def _boxes():
    from test_torch_bvh import port_box, reference_box

    if "boxes" not in _CACHE:
        _CACHE["boxes"] = (reference_box(16, 16, 1, level=2), port_box(16, 16, 1, level=2))
    return _CACHE["boxes"]


def _captures():
    if "capture" not in _CACHE:
        js, ts = _boxes()
        jwv = _reference_tool("wavefront_visits")
        ref = jwv.capture_pool_rays(js, warm_chunks=1, pool=2048)
        port = twv.capture_pool_rays(scene_to(ts, "cpu"), warm_chunks=1, pool=2048)
        _CACHE["capture"] = ({k: np.array(v) for k, v in ref.items()}, port)
    return _CACHE["capture"]


def test_capture_pool_rays_matches_reference():
    """The two packages' paths agree to an ulp at each cast and shading
    step, and the ulps grow over the bounces (hit points up to 6e-3 apart
    in a box 550 units wide after 8 iterations); a lane whose path ends
    in one package and goes on in the other (1 of 2,048 here) shifts the
    work queue, so every fresh lane after it takes the next item. Those
    are counted (at most 0.5% of the lanes), the fresh lanes after the
    first of them are left out, and every other lane is held at rtol 1e-5
    (atol 1e-2 on origins, 1e-5 on directions) with equal bounce depths."""
    ref, port = _captures()
    keys = ("ox", "oy", "oz", "dx", "dy", "dz")
    assert set(port) == set(ref) == {*keys, "bounce", "alive"}
    assert port["ox"].shape == (2048,) and port["ox"].dtype == np.float32
    assert 0 < ref["bounce"].max() and ref["alive"].mean() > 0.5
    flip = (port["alive"] != ref["alive"]) | (port["bounce"] != ref["bounce"])
    assert flip.mean() <= 0.005
    first = np.nonzero(flip)[0][0] if flip.any() else flip.shape[0]
    shifted = (ref["bounce"] == 0) & (np.arange(flip.shape[0]) > first)
    held = ~flip & ~shifted
    assert held.mean() >= 0.85
    for k in keys:
        atol = 1e-2 if k.startswith("o") else 1e-5
        np.testing.assert_allclose(port[k][held], ref[k][held], rtol=1e-5, atol=atol,
                                   err_msg=k)


def test_pool_shadow_rays_live_count():
    """Both packages' _pool_shadow_rays on the reference's captured rays
    thin to the same live shadow rays, with equal tfar masks."""
    import jax.numpy as jnp
    from gdpt_tpu.core.soa import V3 as JV3
    from gdpt_tpu.integrators import path_soa as jps

    js, ts = _boxes()
    ts = scene_to(ts, "cpu")
    ref, _ = _captures()
    jsol = _reference_tool("speed_of_light")
    eps = js.static.intersection_epsilon
    jorg = JV3(*(jnp.asarray(ref[k]) for k in ("ox", "oy", "oz")))
    jd = JV3(*(jnp.asarray(ref[k]) for k in ("dx", "dy", "dz")))
    jtn = jnp.where(jnp.asarray(ref["bounce"]) == 0, 0.0, eps)
    _, _, jtf, jlive = jsol._pool_shadow_rays(js, jps.scene_soa_from_aos(js), jorg, jd,
                                              jnp.asarray(ref["alive"]), jtn)
    torg, td = tsol._rays(np.stack([ref[k] for k in ("ox", "oy", "oz")], 1),
                          np.stack([ref[k] for k in ("dx", "dy", "dz")], 1), "cpu")
    ttn = torch.where(torch.from_numpy(ref["bounce"]) == 0, 0.0, eps)
    _, _, ttf, tlive = tsol._pool_shadow_rays(ts, tps.scene_soa_from_aos(ts), torg, td,
                                              torch.from_numpy(ref["alive"]), ttn)
    assert tlive == jlive > 0
    np.testing.assert_array_equal(ttf.numpy() > 0, np.asarray(jtf) > 0)


def test_fma_peak_plain_matches_float64_recurrence():
    """Bit for bit numpy's recurrence rounded to float32 after each
    float64 step; within rtol 2e-5 of the float64 recurrence never
    rounded (4,096 float32 roundings a chain drift up to 1.06e-5 from
    it)."""
    x = fp.block(1024)
    got = fp.fma_peak_plain(x)
    a, b = np.float64(fp.A), np.float64(fp.B)
    xn = x.numpy()
    starts = [xn, xn * np.float32(fp.A), xn + np.float32(fp.B),
              xn * np.float32(fp.A) + np.float32(fp.B)]
    stepped = list(starts)
    exact = [s.astype(np.float64) for s in starts]
    for _ in range(fp.STEPS):
        stepped = [(s.astype(np.float64) * a + b).astype(np.float32) for s in stepped]
        exact = [e * a + b for e in exact]
    for g, s, e in zip(got, stepped, exact):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy().view(np.int32), s.view(np.int32))
        np.testing.assert_allclose(g.numpy(), e, rtol=2e-5)
    assert fp.flops(1024) == 2 * 4 * 1024 * 4096


def test_fma_peak_takes_its_plain_version_only_on_the_cpu(monkeypatch):
    x = fp.block(256)
    for g, r in zip(fp.fma_peak(x, steps=128), fp.fma_peak_plain(x, steps=128)):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="multiple of 64"):
        fp.fma_peak(x, steps=100)
    with pytest.raises(ValueError, match="cpu tensors"):
        fp.fma_peak_plain(torch.zeros(8, device="meta"))
    monkeypatch.setattr(fp, "fma_peak_plain", None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp.fma_peak(torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        fp.time_ms(x)


def test_merge_replaces_another_cards_rows():
    sol = {"cbox_512_path": {"card": "other", "sol_kernel_inc_mrays": 1.0, "stale": 1}}
    rows = {"cbox_512_path": {"card": "this", "sol_kernel_bounce_mrays": 50.0,
                              "sol_kernel_inc_mrays": 40.0, "visit_floor_inc_mrays": 80.0}}
    out = tsol.merge(sol, rows)
    assert "stale" not in out["cbox_512_path"]
    assert out["cbox_512_path"]["kernel_floor_frac"] == 0.5
    tsol.merge(out, {"cbox_512_path": {"card": "this", "visit_floor_bounce_mrays": 100.0}})
    assert out["cbox_512_path"]["kernel_floor_frac"] == 0.5
    assert out["cbox_512_path"]["sol_kernel_inc_mrays"] == 40.0


@pytest.mark.gpu
def test_fma_peak_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = fp.block(4096, "cuda")
    before = fp.LAUNCHES["fma_peak"]
    got = fp.fma_peak(x)
    assert fp.LAUNCHES["fma_peak"] == before + 1
    for g, r in zip(got, fp.fma_peak_plain(x.cpu())):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["cbox", "icosphere box"])
def test_chained_cast_matches_one_cast(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    host = (tpresets.cornell_box(64, 64, spp=1) if scene == "cbox"
            else tpresets.icosphere_box(64, 64, 1, [(3, (368.0, 100.0, 351.0), 100.0)]))
    s = scene_to(host, "cuda")
    sc = tps.scene_soa_from_aos(s)
    coh, inc = tsol._ray_batches(s, sc, M)
    for rays in (coh, inc):
        kept = []
        assert tsol._timed_mrays(s.static, sc.geom, *rays, keep=kept) > 0
        kept_any = []
        assert tsol._timed_occluded_mrays(s.static, sc.geom, *rays, keep=kept_any) > 0
        for last, cast in kept + kept_any:
            for a, b in zip(last, cast()):
                assert torch.equal(a, b)
