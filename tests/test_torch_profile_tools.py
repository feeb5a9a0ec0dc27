"""The port's stage profilers (gdpt_tpu_torch/tools/profile_render.py,
profile_wavefront.py, profile_nee.py) against the reference's tools of
the same names, on the CPU.

Each reference tool runs its own main() on a 16x16 cbox written by the
port's scene/xml_writer.py (depth 6; brute force, K1 and K2's plain
versions in the port), its printed lines captured; the port's profile()
runs on the same file parsed by the port. Their numbers that are not
times are held together: live lanes per bounce (profile_render, 4
bounces), the steady state's alive lanes and queue position and NEE's
shadow rays (profile_wavefront: a pool of 1,024 lanes after 8 iterations
of a 16 spp queue), the pool and its live shadow rays (profile_nee). The
camera rays of the two packages differ by ulps (the Gaussian filter's
Box-Muller) and a captured pool drifts further (ROADMAP.md C, "Ray
populations and pool captures"), so each count is held to within 0.5% of
the lanes it counts from; the stage names and order are the reference's.
Without a card and without --device cpu each main() prints one error line
and returns 2. The reference tools read and set environment variables and
sys.path when imported: both are restored after each test.
"""

import contextlib
import io
import os
import re
import sys

import pytest
import torch

from gdpt_tpu_torch.scene import presets, xml_writer
from gdpt_tpu_torch.tools import profile_nee, profile_render, profile_wavefront, stand_ins

from test_torch_bench import reference_script
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

TOOLS = [profile_render, profile_wavefront, profile_nee]


@pytest.fixture(scope="module")
def cbox_file(tmp_path_factory):
    return xml_writer.write_scene(str(tmp_path_factory.mktemp("cbox")),
                                  **presets.cornell_box_parts(16, 16, 1, max_depth=6))


def run_reference(tool, argv):
    """The reference's tools/<tool>.py main() with argv; its stdout. The
    environment and sys.path are put back afterwards."""
    env, path, argv0 = dict(os.environ), list(sys.path), list(sys.argv)
    buf = io.StringIO()
    try:
        mod = reference_script(f"tools/{tool}.py")
        sys.argv = [f"tools/{tool}.py", *argv]
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:], sys.argv[:] = path, argv0
    return buf.getvalue()


def near(a, b, lanes):
    """Counts within 0.5% of the lanes they count from."""
    return abs(a - b) <= 0.005 * lanes


def _port_scene(path):
    return stand_ins.load(path, device="cpu")[0]


def test_profile_render_live_lanes_match_reference(cbox_file):
    out = run_reference("profile_render", [cbox_file, "--bounces", "4", "--skip-probes"])
    ref = {m[0]: int(m[1]) for m in re.findall(r"^\s+(primary|bounce\d+)\s+(\d+)\s", out, re.M)}
    rows = profile_render.profile(_port_scene(cbox_file), bounces=4, reps=1)
    port = {name: live for name, live, *_ in profile_render.per_bounce(rows)}
    assert list(port) == list(ref) == ["primary"] + [f"bounce{b}" for b in range(1, 5)]
    for k in ref:
        assert near(port[k], ref[k], 256), (k, port[k], ref[k])
    assert rows[1]["stage"] == "intersect" and rows[1]["hits"] == port["bounce1"]
    stages = [r["stage"] for r in rows if r["bounce"] == 1]
    assert stages == ["nee_rays", "occluded", "bsdf", "intersect", "shade", "update"]
    assert all(r["wall_ms"] > 0 and r["launches"] is None and r["device_ms"] is None
               for r in rows)


def test_profile_wavefront_steady_state_matches_reference(cbox_file):
    out = run_reference("profile_wavefront", [cbox_file, "--pool", "1024", "--warm", "1",
                                              "--spp", "16"])
    alive, pool = map(int, re.search(r"alive=(\d+)/(\d+)", out).groups())
    nxt, total = map(int, re.search(r"next_item=(\d+)/(\d+)", out).groups())
    shadow = int(re.search(r"\((\d+) shadow rays\)", out).group(1))
    rows = profile_wavefront.profile(_port_scene(cbox_file), pool=1024, warm=1, spp=16, reps=1)
    by = {r["stage"]: r for r in rows}
    st = by["steady_state"]
    assert (st["pool"], st["total"], st["iters"]) == (pool, total, 8) == (1024, 4096, 8)
    assert near(st["alive"], alive, pool) and near(st["next_item"], nxt, pool)
    assert near(by["nee"]["shadow_rays"], shadow, pool)
    assert by["trace_sorted"]["rays"] == by["trace_unsorted"]["rays"] > 0
    assert list(by) == ["steady_state", "body", "regen", "trace_sorted", "trace_unsorted",
                        "shade_hit", "gather_params", "nee", "bsdf", "scatter", "sum"]
    assert by["sum"]["parts"].count("scatter") == 3
    assert by["sum"]["wall_ms"] == pytest.approx(sum(by[k]["wall_ms"]
                                                     for k in by["sum"]["parts"]))


def test_profile_wavefront_leaves_the_state_it_times(cbox_file):
    """The body updates its state in place; the tool times it on copies,
    so every stage sees the same steady state."""
    scene = _port_scene(cbox_file)
    a = profile_wavefront.profile(scene, pool=1024, warm=1, spp=16, reps=1)
    b = profile_wavefront.profile(scene, pool=1024, warm=1, spp=16, reps=2)
    for ra, rb in zip(a, b):
        assert ra["stage"] == rb["stage"]
        for key in ("alive", "next_item", "rays", "shadow_rays"):
            assert ra.get(key) == rb.get(key), (ra["stage"], key)


def test_profile_nee_matches_reference(cbox_file):
    out = run_reference("profile_nee", [cbox_file, "--pool", "1024"])
    pool = int(re.search(r"pool=(\d+)", out).group(1))
    live = int(re.search(r"\((\d+) live shadow rays\)", out).group(1))
    rows = profile_nee.profile(_port_scene(cbox_file), pool=1024, reps=1)
    by = {r["stage"]: r for r in rows}
    assert by["pool"]["pool"] == pool == 1024
    assert near(by["occluded"]["live_shadow"], live, pool)
    assert [r["stage"] for r in rows[1:]] == ["sample_light_point", "eval_bsdf", "pdf_bsdf",
                                             "occluded", "nee_soa"]


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_refuses_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["cbox"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and len(err.strip().splitlines()) == 1 and "--device cpu" in err


def test_main_runs_on_the_cpu(cbox_file, capsys):
    assert profile_render.main([cbox_file, "--bounces", "2", "--skip-probes",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^\s+bounce2\s+\d+\s", out, re.M) and "TOTAL" in out
