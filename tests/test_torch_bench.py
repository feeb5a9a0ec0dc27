"""The port's bench (gdpt_tpu_torch/bench.py) against the reference's
bench.py, on the CPU.

Both packages' `_render` render a 16x16 cbox (`path` and `gradpath`, 2
spp, depth 4) and the 16x16 version-6 grid scene of
tests/test_torch_volpath.py: the images at the port's gate (at least 99%
of values within rtol 1e-3 / atol 1e-4, the means within 0.1%), the ray
counts equal for `path` and `volpath` and within 0.1% for `gradpath` (the
port casts through K1/K2's plain versions where the reference walks in
XLA, so a hit distance can move by an ulp and flip a rare probe).
bench_config's row has the reference's keys for the same scene, less
`vs_baseline` and `episode_retries`. Each branch of the ceiling logic
(sol_detail) is held on hand-made rows: packet mix ceiling, pool and bounce
fall-backs, brute force with a kernel row, with a stale kernel row (the
flop floor), with both stale (no mfu_est), volumetric (no mfu_est).
main() prints the reference's error line for each missing scene file and
the headline last, lets any other failure through, and without a card and
without --device cpu prints the error line and returns 2. load_sol keeps
only rows of the running card's name.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gdpt_tpu_torch import bench
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import gate, port_scene, reference_scene

ROOT = Path(__file__).resolve().parents[1]
KINDS = ["path", "gradpath", "volpath"]
_CACHE = {}


def reference_script(relpath):
    """The reference's script at `relpath` (from the repository's root),
    loaded as a module; the other test_torch_* files of the measurement
    entry points import this."""
    name = "reference_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_bench():
    if "mod" not in _CACHE:
        _CACHE["mod"] = reference_script("bench.py")
    return _CACHE["mod"]


def _scene(presets, kind):
    if kind == "volpath":
        return (port_scene if presets is tpresets else reference_scene)("grid")
    return presets.cornell_box(16, 16, spp=2, max_depth=4, integrator=kind)


def _renders(kind):
    if kind not in _CACHE:
        from gdpt_tpu.scene import presets as jpresets

        ji, jr = _reference_bench()._render(_scene(jpresets, kind), spp=2, seed=0)
        ti, tr = bench._render(_scene(tpresets, kind), spp=2, seed=0, device="cpu")
        _CACHE[kind] = (np.asarray(ji), float(jr), ti, float(tr))
    return _CACHE[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_render_matches_reference(kind):
    ji, jr, ti, tr = _renders(kind)
    gate(ti, ji, float(np.mean(ji)))
    if kind == "gradpath":
        assert abs(tr - jr) <= 1e-3 * jr
    else:
        assert tr == jr


def _rows(capsys, fn):
    fn()
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    return lines[-1]


def test_bench_config_row_has_the_reference_keys(capsys):
    from gdpt_tpu.scene import presets as jpresets

    ref_bench = _reference_bench()
    ref = _rows(capsys, lambda: ref_bench.bench_config(
        "cbox_16", lambda: _scene(jpresets, "path"), 2))
    port = _rows(capsys, lambda: bench.bench_config(
        "cbox_16", lambda: _scene(tpresets, "path"), 2, device="cpu"))
    assert set(port) == set(ref) - {"vs_baseline"}
    assert set(port["detail"]) == set(ref["detail"]) - {"vs_baseline", "episode_retries"}
    assert port["metric"] == ref["metric"] == "cbox_16_Mrays_per_sec_per_chip"
    assert port["unit"] == ref["unit"] == "Mrays/s"
    assert port["detail"]["platform"] == "cpu" and port["detail"]["res"] == [16, 16]
    assert bench.bench_config.last_rays == _renders("path")[3]


def test_bench_config_with_a_ceiling_and_a_stand_in(capsys):
    sol = {"box": {"backend": "packet", "sol_kernel_pool_mrays": 1e6, "kernel_floor_frac": 0.4}}
    name, mrays, detail = bench.bench_config(
        "box", lambda: _scene(tpresets, "path"), 2, sol=sol, device="cpu",
        stands_in_for="sponza_gradpath", reduced=("spp: 2 of 4",))
    assert detail["sol_ceiling_mrays"] == 1e6 and detail["sol_kernel_mrays"] == 1e6
    assert detail["mfu_est"] == round(mrays / 1e6, 3) and detail["kernel_floor_frac"] == 0.4
    assert detail["stands_in_for"] == "sponza_gradpath"
    assert detail["reduced"] == ["spp: 2 of 4"]


PACKET = {"backend": "packet", "sol_mix_ceiling_mrays": 50.0, "sol_kernel_pool_mrays": 60.0,
          "sol_kernel_bounce_mrays": 80.0, "sol_kernel_inc_mrays": 90.0,
          "kernel_floor_frac": 0.3}
BRUTE = {"backend": "brute", "sol_kernel_bounce_mrays": 400.0, "sol_kernel_inc_mrays": 500.0,
         "sol_flop_floor_mrays": 1000.0}
CEILING_CASES = {
    # case: (config name, Mrays/s, SOL row, expected keys of sol_detail)
    "packet mix": ("box", 10.0, PACKET, {"mfu_est": 0.2, "sol_ceiling_mrays": 50.0,
                                         "sol_kernel_mrays": 60.0, "kernel_floor_frac": 0.3}),
    "packet pool": ("box", 12.0, {"sol_kernel_pool_mrays": 60.0, "sol_kernel_bounce_mrays": 8.0},
                    {"mfu_est": 0.2, "sol_ceiling_mrays": 60.0, "sol_kernel_mrays": 60.0}),
    "bounce": ("box", 4.0, {"sol_kernel_bounce_mrays": 8.0},
               {"mfu_est": 0.5, "sol_ceiling_mrays": 8.0, "sol_kernel_mrays": 8.0}),
    "incoherent": ("box", 4.0, {"sol_kernel_inc_mrays": 16.0},
                   {"mfu_est": 0.25, "sol_ceiling_mrays": 16.0}),
    "brute kernel": ("cbox", 200.0, BRUTE, {"mfu_est": 0.5, "sol_ceiling_mrays": 400.0,
                                            "sol_kernel_mrays": 400.0}),
    "brute stale kernel": ("cbox", 600.0, BRUTE, {"mfu_est": 0.6, "sol_ceiling_mrays": 1000.0,
                                                  "sol_kernel_mrays": 400.0}),
    "brute floor only": ("cbox", 250.0, {"backend": "brute", "sol_flop_floor_mrays": 1000.0},
                         {"mfu_est": 0.25, "sol_ceiling_mrays": 1000.0}),
    "brute both stale": ("cbox", 2000.0, BRUTE, {}),
    "volpath": ("volpath_grid6", 5.0, dict(BRUTE, sol_kernel_bounce_mrays=7.0),
                {"sol_kernel_mrays": 7.0}),
    "no row": ("cbox", 5.0, {}, {}),
}


@pytest.mark.parametrize("case", CEILING_CASES)
def test_ceiling_branches(case):
    name, mrays, srow, want = CEILING_CASES[case]
    assert bench.sol_detail(name, mrays, srow) == want


def test_main_reports_missing_scene_files(tmp_path, capsys):
    xml = ["veach_mi", "disney_bsdf", "volpath_test6", "sponza_gradpath", "disney_array_512"]
    assert bench.main(["--scenes", str(tmp_path), "--device", "cpu",
                       "--only", ",".join(xml)]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in lines[:-1]] == xml
    for row, cfg in zip(lines, [c for c in bench.CONFIGS if c.name in xml]):
        assert row["error"] == (f"[Errno 2] No such file or directory: "
                                f"'{tmp_path / cfg.scene_file}'")
    head = lines[-1]
    assert head["metric"] == "cbox_512_path_Mrays_per_sec_per_chip" and head["value"] == 0.0
    assert set(head["detail"]) == set(xml) and "vs_baseline" not in head


def test_main_lets_other_failures_through(tmp_path):
    bad = tmp_path / "veach_mi" / "mi.xml"
    bad.parent.mkdir()
    bad.write_text("<scene version='0.5.0'>")  # not well-formed
    with pytest.raises(Exception) as err:
        bench.main(["--scenes", str(tmp_path), "--device", "cpu", "--only", "veach_mi"])
    assert not isinstance(err.value, FileNotFoundError)


def test_main_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--only", "cbox_512_path"]) == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and "CUDA" in json.loads(out[0])["error"]


def test_configs_and_load_sol(tmp_path, monkeypatch):
    names = [c.name for c in bench.CONFIGS]
    assert names[:6] == ["cbox_512_path", "veach_mi", "disney_bsdf", "volpath_test6",
                         "sponza_gradpath", "disney_array_512"]
    stand = {c.name: c for c in bench.CONFIGS if c.stands_in_for}
    assert {k: c.stands_in_for for k, c in stand.items()} == {
        "icosphere_box_gradpath": "sponza_gradpath", "volpath_grid6": "volpath_test6"}
    assert all(c.reduced for c in stand.values())
    path = tmp_path / "sol.json"
    path.write_text(json.dumps({"a": {"card": "Card X", "v": 1}, "b": {"card": "Card Y"}}))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Card X")
    assert bench.load_sol(path, "cuda") == {"a": {"card": "Card X", "v": 1}}
    assert bench.load_sol(path, "cpu") == {}
    assert bench.load_sol(tmp_path / "none.json", "cuda") == {}
