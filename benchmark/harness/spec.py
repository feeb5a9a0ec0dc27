"""The benchmark's data: BENCHMARK.json and the files it names.

A cell (`workloads` entry) names a configuration and a traffic mix; each
is a file found by its name:

- benchmark/configs/<config>.json: the scene's builder
  (benchmark/scenes/<module>.py, function <builder>), its film, depth and
  integrator, and the correctness check's sampling and limits;
- benchmark/traffic/<traffic>.json: the frames a client asks for;
- benchmark/metrics/<metric>.py: a reader `read(record)` of one metric;
- benchmark/checks/<module>.py: `compare(run)`, the comparison with
  the plain reference that decides `correct`. <module> is the config's
  `check.module` where it names one, else the config's integrator: a
  config whose scene its integrator's reference cannot render names a
  check of its own, which brings its own reference.

A new configuration, mix, metric or check is a new file, found by the
name that BENCHMARK.json or a config gives it.
"""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


class SpecError(Exception):
    pass


def load_spec(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind, name, root=ROOT):
    path = Path(root) / "benchmark" / kind / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"no {kind} file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(kind, name, root=ROOT):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no {kind} module {path}")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its config, traffic and the
    metrics it reports in each trace mode."""

    def __init__(self, spec, name, root=ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config_name = self.entry["config"]
        self.traffic_name = self.entry["traffic"]
        self.config = load_json("configs", self.config_name, root)
        self.traffic = load_json("traffic", self.traffic_name, root)
        self.run_seconds = spec["run_seconds"]
        self.metrics = {
            trace: [m for m in spec[key] if name in m.get("workloads", [name])]
            for trace, key in ((0, "end_to_end"), (1, "per_layer"))}
        self.root = Path(root)

    def readers(self, trace):
        """(metric entry, reader module) of each metric of a trace mode."""
        return [(m, load_module("metrics", m["name"], self.root)) for m in self.metrics[trace]]

    def check(self):
        """The config's check: checks/<check.module>.py, else
        checks/<integrator>.py."""
        module = self.config.get("check", {}).get("module", self.config["integrator"])
        return load_module("checks", module, self.root)
