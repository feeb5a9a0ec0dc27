"""The port's occupancy report (gdpt_tpu_torch/tools/occupancy_report.py)
against the reference's tools/occupancy_report.py, the render switch it
drives, and two repairs of the port's dispatch, on the CPU.

The reference's main() runs `path` (1 spp, the wavefront row) on a
16x16 box around a level-2 icosphere written by the port's
scene/xml_writer.py (its scene table pointed at the file), under
GDPT_PACKET=1 (on the CPU the reference otherwise walks its XLA BVH and
runs its wavefront one iteration a chunk, the port its packet table and
eight), and prints its JSON rows; the port's run() renders the same file.
The rows carry the same keys and labels, the image means agree within
0.5% and the wavefront row's occupancy within 0.5% of it (the camera
rays differ by ulps: ROADMAP.md C). On the brute-force cbox and the 16x16
grid-medium volpath scene the wavefront row is the banded loop, as the
reference's GDPT_WAVEFRONT=1 is there: the same rays and mean, and no
occupancy; the renderers' own wavefront=True runs the lane pool there,
which traces the same rays and gives the same mean (rtol 1e-5: the same
samples summed in another order). render.render's wavefront= is
GDPT_WAVEFRONT. Repairs: an unknown integrator raises the reference's
ValueError in both packages (the parser rejects unknown names, so the
scene is built in code); the brute-force casts take a per-lane tnear in
one K1 or K2 launch, as the reference's XLA casts do (the wavefront casts
primary rays from 0 and bounce rays from the intersection epsilon), held
to the reference's intersect_brute_soa and occluded_brute_soa on a
captured cbox pool: equal prims and blocked flags, t within rtol 1e-5.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core.dtypes import BIG
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import gdpt_soa as tgdpt
from gdpt_tpu_torch.integrators import path_soa as tps
from gdpt_tpu_torch.integrators import volpath_soa as tvol
from gdpt_tpu_torch.integrators import render
from gdpt_tpu_torch.scene import presets, xml_writer
from gdpt_tpu_torch.scene.build import scene_to
from gdpt_tpu_torch.tools import occupancy_report, stand_ins
from gdpt_tpu_torch.tools import wavefront_visits as twv

from test_torch_bench import reference_script
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_profile_tools import run_reference
from test_torch_volpath import port_scene

KEYS = ["scene", "integrator", "mode", "spp", "wall_s", "Mrays", "spp_per_s", "mean"]


@pytest.fixture(scope="module")
def box_file(tmp_path_factory):
    return xml_writer.write_scene(
        str(tmp_path_factory.mktemp("box")), **presets.icosphere_box_parts(
            16, 16, 1, balls=[(2, (368.0, 100.0, 351.0), 100.0)], max_depth=6))


def test_occupancy_report_matches_reference(box_file, monkeypatch):
    real = reference_script

    def pointed(relpath):
        mod = real(relpath)
        mod.SCENES = {"box": box_file}
        return mod

    monkeypatch.setattr("test_torch_profile_tools.reference_script", pointed)
    monkeypatch.setenv("GDPT_PACKET", "1")
    out = run_reference("occupancy_report", ["box", "--integ", "path", "--mode", "wavefront",
                                             "--spp-path", "1"])
    (ref,) = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    scene = stand_ins.load(box_file, device="cpu")[0]
    assert not scene.static.use_brute_force
    (port,) = occupancy_report.run(scene, "box", spp_path=1, integ_only="path",
                                   mode_only="wavefront", out=lambda s: None)
    assert list(port)[:len(KEYS)] == KEYS and set(ref) <= set(port)
    labels = ("scene", "integrator", "mode", "spp")
    assert [port[k] for k in labels] == [ref[k] for k in labels] == ["box", "path",
                                                                     "wavefront", 1]
    assert port["mean"] == pytest.approx(ref["mean"], rel=5e-3)
    assert port["occupancy"] == pytest.approx(ref["occupancy"], rel=5e-3)
    assert port["iterations"] > 0 and port["rays"] > 0


@pytest.mark.parametrize("kind", ["cbox", "volpath"])
def test_banded_and_wavefront_rows_agree(kind):
    scene = (scene_to(presets.cornell_box(16, 16, 1, max_depth=4), "cpu") if kind == "cbox"
             else scene_to(port_scene("grid"), "cpu"))
    assert scene.static.use_brute_force
    rows = occupancy_report.run(scene, kind, spp_path=1, spp_gdpt=1, out=lambda s: None)
    want = ["volpath"] if kind == "volpath" else ["path", "gradpath"]
    assert [r["integrator"] for r in rows[::2]] == want
    renderers = {"path": tps.render_soa, "gradpath": tgdpt.render_gradpath_soa,
                 "volpath": tvol.render_volpath_soa}
    accums = {"path": tps.render_soa_wavefront, "gradpath": tgdpt._gdpt_wavefront_accum,
              "volpath": tvol._vol_wavefront_accum}
    for banded, wave in zip(rows[::2], rows[1::2]):
        assert (banded["mode"], wave["mode"]) == ("banded", "wavefront")
        assert banded["rays"] == wave["rays"] > 0 and wave["mean"] == banded["mean"]
        assert "occupancy" not in banded and "occupancy" not in wave
        out = renderers[banded["integrator"]](scene, spp=1, seed=0, return_stats=True,
                                              wavefront=True)
        img, rays = out[0], out[-1]
        assert rays == banded["rays"]
        assert float(np.mean(img)) == pytest.approx(banded["mean"], rel=1e-5, abs=1e-5)
        assert 0 < accums[banded["integrator"]].last_occupancy <= 1


def test_render_takes_the_wavefront_switch(monkeypatch):
    """render.render's wavefront= is GDPT_WAVEFRONT: on (the default) a
    BVH scene takes the lane pool and a brute-force one the banded loop;
    off, every scene takes the banded loop."""
    calls = []
    real = tps.render_soa_wavefront
    monkeypatch.setattr(tps, "render_soa_wavefront",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    brute = presets.cornell_box(16, 16, 1, max_depth=4)
    render.render(brute, device="cpu")
    render.render(brute, device="cpu", wavefront=True)
    assert not calls
    bvh = presets.cornell_box(16, 16, 1, max_depth=4, force_bvh=True)
    a = render.render(bvh, device="cpu", return_stats=True, wavefront=False)
    assert not calls
    b = render.render(bvh, device="cpu", return_stats=True)
    assert calls and a[1] == b[1]
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-6)


def test_unknown_integrator_raises_value_error_in_both_packages():
    from gdpt_tpu.integrators import render as jrender
    from gdpt_tpu.scene import presets as jpresets

    def bogus(scene):
        st = scene.static
        return scene._replace(static=dataclasses.replace(
            st, options=dataclasses.replace(st.options, integrator="bogus")))

    with pytest.raises(ValueError, match="unknown integrator: bogus"):
        jrender.render(bogus(jpresets.cornell_box(16, 16, 1)))
    with pytest.raises(ValueError, match="unknown integrator: bogus"):
        render.render(bogus(presets.cornell_box(16, 16, 1)), device="cpu")


@pytest.mark.parametrize("cast", ["closest", "any_hit"])
def test_brute_casts_take_a_per_lane_tnear(cast):
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse_soa as jtrs
    from gdpt_tpu.core.soa import V3 as JV3
    from gdpt_tpu.integrators import path_soa as jps
    from gdpt_tpu.scene import presets as jpresets

    ts = scene_to(presets.cornell_box(16, 16, 1, max_depth=4), "cpu")
    rays = twv.capture_pool_rays(ts, warm_chunks=1, pool=1024)
    eps = ts.static.intersection_epsilon
    tnear = np.where(rays["bounce"] == 0, 0.0, eps).astype(np.float32)
    assert 0 < (rays["bounce"] == 0).sum() < 1024
    org, d = (tuple(rays[k] for k in keys) for keys in (("ox", "oy", "oz"), ("dx", "dy", "dz")))
    js = jpresets.cornell_box(16, 16, 1, max_depth=4)
    jg = jps.scene_soa_from_aos(js).geom
    g = tps.scene_soa_from_aos(ts).geom
    targs = (V3(*map(torch.from_numpy, org)), V3(*map(torch.from_numpy, d)),
             torch.from_numpy(tnear))
    jargs = (JV3(*map(jnp.asarray, org)), JV3(*map(jnp.asarray, d)), jnp.asarray(tnear))
    if cast == "closest":
        hit, _ = trs.intersect_brute_soa(ts.static, g, *targs, BIG)
        jhit = jtrs.intersect_brute_soa(js.static, jg, *jargs, BIG)
        np.testing.assert_array_equal(hit.prim_id.numpy(), np.asarray(jhit.prim_id))
        ok = hit.prim_id.numpy() >= 0
        np.testing.assert_allclose(hit.t.numpy()[ok], np.asarray(jhit.t)[ok], rtol=1e-5)
    else:
        tfar = np.full(1024, 1e4, np.float32)
        got = trs.occluded_brute_soa(ts.static, g, *targs, torch.from_numpy(tfar))
        ref = jtrs.occluded_brute_soa(js.static, jg, *jargs, jnp.asarray(tfar))
        np.testing.assert_array_equal(got.numpy() > 0, np.asarray(ref) > 0)


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert occupancy_report.main(["sponza"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and len(err.strip().splitlines()) == 1 and "--device cpu" in err
