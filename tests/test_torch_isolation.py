"""The port stands alone: no jax and nothing of gdpt_tpu in gdpt_tpu_torch
or chip_smoke.py (every module, found by walking the package, and every
native source under csrc/), nothing compiled when a module is imported,
CUDA by default, the CPU only when asked for."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import render
from gdpt_tpu_torch.scene import presets

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "gdpt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
NATIVE = sorted((ROOT / "gdpt_tpu_torch" / "csrc").iterdir())


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gdpt_tpu")


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", "")) in
              ("__import__", "import_module")):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported_names(tree) if _forbidden(n)]
    assert not bad, f"{path}: imports {bad}"


def test_slice_modules_are_covered():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("accel/bvh.py", "accel/native_build.py", "accel/packet_trace.py",
                   "accel/packet_kernels.py", "accel/traverse_soa.py", "convert.py",
                   "ops/poisson.py", "ops/materials_soa.py", "ops/textures_soa.py",
                   "integrators/gdpt_soa.py", "integrators/render.py",
                   "integrators/path_fused.py",
                   "tools/visit_microbench.py", "cli.py", "__main__.py", "core/image.py",
                   "core/exr_piz.py", "scene/loaders.py", "scene/parser.py",
                   "scene/xml_writer.py", "integrators/aux.py", "utils/checkpoint.py",
                   "utils/profiling.py", "utils/host_parallel.py", "core/rng.py",
                   "core/math.py", "ops/microfacet.py", "ops/materials.py", "ops/lights.py",
                   "ops/media.py", "ops/intersect.py", "integrators/volpath.py",
                   "integrators/path.py", "integrators/gdpt.py", "parallel/sharding.py",
                   "accel/traverse.py", "accel/super16.py", "bench.py", "entry.py",
                   "examples/small_gdpt.py", "tools/speed_of_light.py",
                   "tools/wavefront_visits.py", "tools/fma_peak.py", "tools/stand_ins.py",
                   *(f"tools/{name}" for name in TOOLS)):
        assert f"gdpt_tpu_torch/{module}" in names
    assert {p.name for p in NATIVE} == {"brute_intersect.cu", "packet_trace.cu",
                                        "packet_trace_dual.cu", "visit_microbench.cu",
                                        "packet_visit.cuh", "packet_group.cuh",
                                        "bvh_builder.cpp", "fma_peak.cu", "path_fused.cu",
                                        "path_fused.cuh"}


# Reference modules whose counterpart in the port has another name.
RENAMED = {"accel/pallas_intersect.py": "accel/brute_kernels.py",
           "accel/native/__init__.py": "accel/native_build.py"}


def test_every_reference_module_has_a_counterpart():
    """Each module of gdpt_tpu has its port in gdpt_tpu_torch, at the same
    path or at the one RENAMED gives."""
    ported = {str(p.relative_to(ROOT / "gdpt_tpu_torch")) for p in SOURCES[:-1]}
    for path in sorted((ROOT / "gdpt_tpu").rglob("*.py")):
        name = str(path.relative_to(ROOT / "gdpt_tpu"))
        assert RENAMED.get(name, name) in ported, name


# The reference's scripts around its package and their counterparts in the
# port (tools/wavefront_visits.py: capture_pool_rays only).
TOOLS = ["profile_render.py", "profile_wavefront.py", "profile_nee.py", "trace_decompose.py",
         "occupancy_report.py", "ab_dual_kernel.py", "ab_wide_kernel.py", "chain_sweep.py",
         "occl_ab.py"]
SCRIPTS = {"bench.py": "bench.py", "__graft_entry__.py": "entry.py",
           "examples/small_gdpt_tpu.py": "examples/small_gdpt.py",
           "tools/speed_of_light.py": "tools/speed_of_light.py",
           "tools/wavefront_visits.py": "tools/wavefront_visits.py",
           "tools/visit_microbench.py": "tools/visit_microbench.py",
           **{f"tools/{name}": f"tools/{name}" for name in TOOLS}}
# Reference scripts with no counterpart yet; ROADMAP.md names each with
# why it waits.
WAITS = ["bench_ab.py", "env_lookup_bench.py", "kernel_sweep.py", "make_goldens.py",
         "render_gallery.py", "render_sponza_gdpt.py", "sheen_outlier.py", "validate.py",
         "validate_disney.py", "visit_count.py", "wide_visit_count.py"]


def test_every_reference_script_has_a_counterpart_or_waits():
    """Every root-level script of the reference that imports gdpt_tpu has
    its counterpart in gdpt_tpu_torch, or waits in WAITS, which ROADMAP.md
    repeats name by name."""
    ported = {str(p.relative_to(ROOT / "gdpt_tpu_torch")) for p in SOURCES[:-1]}
    scripts = [ROOT / "bench.py", ROOT / "__graft_entry__.py",
               *sorted((ROOT / "examples").glob("*.py")), *sorted((ROOT / "tools").glob("*.py"))]
    uses = [str(p.relative_to(ROOT)) for p in scripts if "gdpt_tpu" in p.read_text()]
    assert uses and set(SCRIPTS) <= set(uses)
    for name in uses:
        if name in SCRIPTS:
            assert SCRIPTS[name] in ported, name
        else:
            assert name.startswith("tools/") and name[len("tools/"):] in WAITS, name
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for name in WAITS:
        assert f"tools/{name}" in roadmap, name


NEW_MODULES = ["ops/poisson.py", "integrators/gdpt_soa.py", "integrators/render.py",
               "tools/visit_microbench.py", "accel/packet_kernels.py", "accel/traverse_soa.py",
               "cli.py", "integrators/aux.py", "utils/checkpoint.py", "core/rng.py",
               "core/math.py", "ops/microfacet.py", "ops/materials.py", "ops/lights.py",
               "ops/media.py", "ops/intersect.py", "integrators/volpath.py",
               "integrators/path.py", "integrators/gdpt.py", "accel/packet_trace.py",
               "integrators/path_soa.py", "integrators/volpath_soa.py", "parallel/sharding.py",
               "accel/traverse.py", "accel/super16.py", "tools/stand_ins.py",
               "integrators/path_fused.py", "integrators/vertex_soa.py",
               *(f"tools/{name}" for name in TOOLS)]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_gradpath_modules_read_no_environment_variable(module):
    """The reference picks its table width, build and cap, the packet
    route, dual and two-phase walks, ray sorts, pool, pool sort and
    wavefront through GDPT_* environment variables; the port takes
    arguments."""
    tree = ast.parse((ROOT / "gdpt_tpu_torch" / module).read_text())
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv")), \
            f"{module}:{node.lineno} reads the environment"
        assert not (isinstance(node, (ast.Import, ast.ImportFrom))
                    and any(a.name == "os" for a in node.names)), f"{module} imports os"


@pytest.mark.parametrize("path", NATIVE, ids=lambda p: p.name)
def test_native_sources_include_only_cuda_and_std_headers(path):
    """A plain C interface: no PyTorch, Python or jax header, so each
    source builds in seconds with nvcc or g++ alone."""
    includes = [line.split()[1] for line in path.read_text().splitlines()
                if line.startswith("#include")]
    # A .cuh holds device code shared by the .cu files and exports nothing.
    assert includes and ('extern "C"' in path.read_text()) == (path.suffix != ".cuh")
    for inc in includes:
        assert inc in ("<cuda_runtime.h>", '"packet_visit.cuh"', '"packet_group.cuh"',
                       '"path_fused.cuh"') or \
            inc.strip("<>") in (
            "algorithm", "cmath", "cstdint", "cstring", "limits", "vector"), inc


def test_a_header_change_rebuilds_the_cuda_sources(tmp_path, monkeypatch):
    """The build's file name hashes a source with the headers it includes."""
    from gdpt_tpu_torch.accel import native_build

    csrc = tmp_path / "csrc"
    shutil.copytree(native_build.CSRC, csrc)
    monkeypatch.setattr(native_build, "CSRC", csrc)
    before = {s: native_build.library_path(s)
              for s in ("packet_trace.cu", "packet_trace_dual.cu", "visit_microbench.cu",
                        "brute_intersect.cu", "bvh_builder.cpp", "fma_peak.cu")}
    with open(csrc / "packet_visit.cuh", "a") as f:
        f.write("// changed\n")
    after = {s: native_build.library_path(s) for s in before}
    users = {"packet_trace.cu", "packet_trace_dual.cu", "visit_microbench.cu"}
    assert {s for s in before if after[s] != before[s]} == users


def test_a_nested_header_change_rebuilds_its_users(tmp_path, monkeypatch):
    """packet_group.cuh, which the two walks include and which includes
    packet_visit.cuh in turn, is hashed into the walks' build keys only."""
    from gdpt_tpu_torch.accel import native_build

    csrc = tmp_path / "csrc"
    shutil.copytree(native_build.CSRC, csrc)
    monkeypatch.setattr(native_build, "CSRC", csrc)
    sources = ("packet_trace.cu", "packet_trace_dual.cu", "visit_microbench.cu",
               "brute_intersect.cu", "bvh_builder.cpp", "fma_peak.cu")
    before = {s: native_build.library_path(s) for s in sources}
    with open(csrc / "packet_group.cuh", "a") as f:
        f.write("// changed\n")
    after = {s: native_build.library_path(s) for s in sources}
    assert {s for s in sources if after[s] != before[s]} == {"packet_trace.cu",
                                                             "packet_trace_dual.cu"}


def test_importing_every_module_builds_nothing():
    """Every module imports in a process where running a compiler (or any
    other program) fails, writes nothing into its build directory (a fresh
    empty one of its own, so no other process's build can race the
    check), and pulls in neither jax nor triton."""
    code = (
        "import pathlib, shutil, subprocess, sys, tempfile\n"
        "def boom(*a, **k): raise AssertionError('a program was run at import')\n"
        "subprocess.run = subprocess.Popen = subprocess.check_output = boom\n"
        "import importlib, pkgutil, gdpt_tpu_torch\n"
        "from gdpt_tpu_torch.accel import native_build\n"
        "native_build.BUILD_DIR = pathlib.Path(tempfile.mkdtemp())\n"
        "try:\n"
        "    names = [m.name for m in pkgutil.walk_packages(gdpt_tpu_torch.__path__, 'gdpt_tpu_torch.')]\n"
        "    for n in names: importlib.import_module(n)\n"
        "    assert len(names) >= 45, names\n"
        "    assert not list(native_build.BUILD_DIR.iterdir())\n"
        "finally:\n"
        "    shutil.rmtree(native_build.BUILD_DIR)\n"
        "assert not {'jax', 'jaxlib', 'triton', 'gdpt_tpu', 'PIL'} & set(sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_render_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        render.render(presets.cornell_box(4, 4, spp=1))


@pytest.mark.parametrize("integrator", ["path", "gradpath"])
def test_render_defaults_to_cuda_for(integrator, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        render.render(presets.cornell_box(4, 4, spp=1, integrator=integrator, force_bvh=True))


@pytest.mark.parametrize("version", [1, 5])
def test_volpath_rungs_default_to_cuda(version, monkeypatch):
    """The per-ray rungs, through render.render and the checkpointed
    render, raise without a card unless the CPU is asked for."""
    from gdpt_tpu_torch.utils import checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = presets.volpath_scene(version=version, width=4, height=4, spp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        render.render(scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.render_with_checkpoints(scene, path="unused.npz")


@pytest.mark.parametrize("integrator", ["path", "gradpath"])
def test_perray_oracles_default_to_cuda(integrator, monkeypatch):
    """With the SoA predicate off, render.render and the checkpointed
    render take the per-ray oracles, which raise without a card unless
    the CPU is asked for; so does gdpt.render_gradpath called directly."""
    from gdpt_tpu_torch.integrators import gdpt
    from gdpt_tpu_torch.ops import materials_soa
    from gdpt_tpu_torch.utils import checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(materials_soa, "supports_soa_materials", lambda scene: False)
    scene = presets.cornell_box(4, 4, spp=1, max_depth=2, integrator=integrator)
    with pytest.raises(RuntimeError, match="CUDA"):
        render.render(scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.render_with_checkpoints(scene, path="unused.npz")
    if integrator == "gradpath":
        with pytest.raises(RuntimeError, match="CUDA"):
            gdpt.render_gradpath(scene)
    assert render.render(scene, device="cpu").shape == (4, 4, 3)


def test_measurement_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The bench's _render and its main, entry(), dryrun_multichip() and
    the small_gdpt example raise (or, the bench's main, exit 2) without a
    card unless the CPU is asked for; the FMA peak is measured on a card
    only."""
    from gdpt_tpu_torch import bench, entry
    from gdpt_tpu_torch.examples import small_gdpt
    from gdpt_tpu_torch.tools import fma_peak

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = presets.cornell_box(4, 4, spp=1, max_depth=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench._render(scene, 1)
    assert bench.main(["--only", "cbox_512_path"]) == 2
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        small_gdpt.main(["1", "--width", "8", "--height", "6"])
    assert not list(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="CUDA"):
        fma_peak.main(["fma_peak"])
    assert bench._render(scene, 1, device="cpu")[0].shape == (4, 4, 3)


def test_render_on_cpu_when_asked():
    img = render.render(presets.cornell_box(8, 8, spp=1, max_depth=3), device="cpu")
    assert img.shape == (8, 8, 3) and img.dtype == np.float32
    assert np.isfinite(img).all() and img.mean() > 0


def test_cuda_tensors_never_reach_a_plain_version(monkeypatch):
    """For a tensor that is not on the CPU the wrappers go to the kernel's
    library (here: its build, which fails without nvcc) or raise; they do
    not carry on with the plain version."""
    from gdpt_tpu_torch.accel import brute_kernels, native_build, packet_kernels
    from gdpt_tpu_torch.tools import visit_microbench

    def no_build(source, verbose=False):
        raise RuntimeError(f"no nvcc for {source}")

    monkeypatch.setattr(native_build, "build", no_build)
    monkeypatch.setattr(packet_kernels, "_lib", None)
    monkeypatch.setattr(packet_kernels, "_lib_dual", None)
    monkeypatch.setattr(visit_microbench, "_lib", None)
    monkeypatch.setattr(brute_kernels, "_lib", None)
    monkeypatch.setattr(packet_kernels, "trace_packets_plain", None)
    monkeypatch.setattr(packet_kernels, "trace_packets_dual_plain", None)
    monkeypatch.setattr(visit_microbench, "visit_microbench_plain", None)
    monkeypatch.setattr(brute_kernels, "intersect_brute_plain", None)
    meta = torch.zeros(8, device="meta")
    tab = type("Tab", (), dict(table=torch.zeros((4, 128), dtype=torch.int32, device="meta"),
                               width=32, stack_n=64))()
    with pytest.raises(ValueError, match="cuda or cpu"):
        packet_kernels.trace_packets(tab, *(meta,) * 8)
    tab.width, tab.stack_n = 16, 64
    with pytest.raises(ValueError, match="cuda or cpu"):
        packet_kernels.trace_packets(tab, *(meta,) * 8, dual=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        visit_microbench.visit_microbench(tab, *(meta,) * 8, 4, "leaf")
    with pytest.raises(ValueError, match="cuda or cpu"):
        brute_kernels.intersect_brute(torch.zeros((9, 1), device="meta"),
                                      torch.zeros((4, 1), device="meta"), 1, 0, *(meta,) * 7, 0.0)
    from gdpt_tpu_torch.tools import fma_peak

    monkeypatch.setattr(fma_peak, "_lib", None)
    monkeypatch.setattr(fma_peak, "fma_peak_plain", None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fma_peak.fma_peak(meta)


def test_package_runs_with_jax_unimportable():
    """A process where `import jax` and `import gdpt_tpu` fail renders."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['gdpt_tpu'] = None\n"
        "from gdpt_tpu_torch.integrators import render\n"
        "from gdpt_tpu_torch.scene import presets\n"
        "img = render.render(presets.cornell_box(4, 4, spp=1, max_depth=2), device='cpu')\n"
        "assert img.mean() > 0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_cuda_or_package(tmp_path, where):
    """Without a card (this CPU host) or without the package beside it,
    chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
