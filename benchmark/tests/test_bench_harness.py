"""The harness: BENCHMARK.json against the contract's shape, cells found
by name, new configs, mixes and metrics taken as new files, the result
line's keys, and the refusals."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec
from benchmark.tests.conftest import CELLS, ROOT, cpu_run, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_json_shape():
    b = spec.load_spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m and "mfu" not in m["name"]
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    # A full check of 24 cells fits its time.
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (b["run_seconds"] + 60)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve(name):
    cell = spec.Cell(spec.load_spec(), name)
    for trace in (0, 1):
        readers = cell.readers(trace)
        assert readers and all(callable(r.read) for _, r in readers)
    assert callable(cell.check().compare)
    assert {"setup_s", "msamples_per_s"} <= {m["name"] for m in cell.metrics[0]}


def test_new_config_traffic_and_metric_are_found(tmp_path):
    """A copy of the benchmark with a new config, traffic mix, metric and
    cell added as files and entries, no existing file edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.load_spec()
    cfg = json.loads((ROOT / "benchmark/configs/cbox_512_path.json").read_text())
    cfg["max_depth"] = 3
    (tmp_path / "benchmark/configs/cbox_shallow.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/pairs_2spp.json").write_text(json.dumps(
        {"loop": "closed", "spp_per_frame": 2, "profile_after": 0, "profile_frames": 1}))
    (tmp_path / "benchmark/metrics/frames_seen.py").write_text(
        "def read(rec):\n    return float(len(rec.frames))\n")
    b["configs"].append(dict(b["configs"][0], name="cbox_shallow",
                             file="benchmark/configs/cbox_shallow.json"))
    b["workloads"].append({"name": "cbox_shallow.pairs_2spp", "config": "cbox_shallow",
                           "traffic": "pairs_2spp", "chips": 1, "why": "a test cell"})
    b["end_to_end"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": ["cbox_shallow.pairs_2spp"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.Cell(spec.load_spec(tmp_path), "cbox_shallow.pairs_2spp", tmp_path)
    res, _, _ = cpu_run(cell, spp=None)
    assert res["correct"]
    assert res["metrics"]["frames_seen"]["value"] == res["attempted"]
    assert set(res["metrics"]) == {"setup_s", "msamples_per_s", "frames_seen"}


@pytest.mark.parametrize("trace", (0, 1))
def test_last_line_has_the_contracts_keys(trace):
    res, out, err = cpu_run(load_cell(CELLS[0]), trace=bool(trace))
    line = json.loads(out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["compared"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "integrator.rays_per_sample" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "msamples_per_s"}
    tail = err.strip().splitlines()[-len(line["compared"]):]
    assert [t.split()[1] for t in tail] == list(line["compared"])
    assert all(v["value"] <= v["limit"] for v in line["compared"].values())


def test_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from benchmark import run

    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_refuses_in_a_bare_checkout(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no result line."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_frame_seeds_are_fixed_by_the_run_seed():
    from benchmark.harness.session import frame_seed

    seeds = [frame_seed(2 ** 31 + 12345, i) for i in range(-2, 100)]
    assert seeds == [frame_seed(2 ** 31 + 12345, i) for i in range(-2, 100)]
    assert len(set(seeds)) == len(seeds) and all(0 <= s < 2 ** 32 for s in seeds)


def test_profiled_wall_leaves_out_the_profilers_stop(monkeypatch):
    """device.window_s is the profiled frames' own wall: a slow stop of
    the profiler (its flush) does not lengthen it."""
    import time

    from benchmark.harness import profile

    stop = profile.Session.stop

    def slow_stop(self):
        time.sleep(2.0)
        stop(self)

    monkeypatch.setattr(profile.Session, "stop", slow_stop)
    res, _, _ = cpu_run(load_cell(CELLS[0]), trace=True)
    assert 0 < res["device"]["window_s"] < 2.0
