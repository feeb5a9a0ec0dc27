"""The frozen scene writer's forms and the check a config names, on the CPU:

- the Cornell configs' files are byte for byte what the writer wrote
  before it took spheres and the metal and glass BSDFs (sha256 pins);
- smallpt's sphere box (gdpt_tpu_torch/examples/small_gdpt.py), given as
  a description of spheres, a sphere light, a disneymetal and a
  roughdielectric, is written and parsed by the program's front end to
  the scene build_scene makes of the same values in code, leaf for leaf;
- a form the writer does not know raises ValueError naming the entry;
- a config's `check.module` picks its check, else its integrator does.
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark.harness import session, spec
from benchmark.scenes import xml_writer
from benchmark.tests.conftest import ROOT

# sha256 of every file the writer wrote for each config before the
# sphere and BSDF forms came in.
PLY = {
    "mesh0.ply": "8d97f505aef4f2ef14092fa744d43c5164fcf94803fa08867c1c7bedbbcb37a7",
    "mesh1.ply": "4f3d89b69973ca8ee826b904de4ecef26eec238f1bff2fd8cf4c7e818f6dd240",
    "mesh2.ply": "867cd36a0a03b309a90dbfd7b4c02d8f7cebf84c2c2bd63b29356398986ec209",
    "mesh3.ply": "8660d71b052c70b3e637dcafc6f971373f056c04274de2cfe326ba1643b99281",
    "mesh4.ply": "20848fe10e4b9f4b844a3b39c78d720e2621344b48b1a8d2c85e9d34e498517c",
    "mesh5.ply": "ca52f7ec71b5b80234a553a485d086d55ca0b5736f05261e4ea1bd3a54cd6165",
    "mesh6.ply": "574aa7cf5b9d31a4a674bde3b4b8612dcc4f21391ee7235ba62cbadba310acb9",
    "mesh7.ply": "7c8e5c9ebba59ef0132af747828ddd23628f543d1b8bd72346c57cda46134faf",
}
PINS = {
    "cbox_512_path": dict(
        PLY, **{"scene.xml": "ddc68459be7ccc782e3e413b030ab990c3a5180297d361c4026e805f4f16207c"}),
    "cbox_512_gradpath": dict(
        PLY, **{"scene.xml": "b2125031de6d007a8fedc8dd950f9e968e521adc3100e96e7f5a49c8411d68ed"}),
}


@pytest.mark.parametrize("config", sorted(PINS))
def test_cornell_configs_are_written_as_before(config, tmp_path):
    desc = session.describe(spec.load_json("configs", config))
    xml_writer.write_scene(str(tmp_path), desc)
    got = {f: hashlib.sha256((tmp_path / f).read_bytes()).hexdigest()
           for f in sorted(os.listdir(tmp_path))}
    assert got == PINS[config]


def _smallpt_parts(monkeypatch, width=16, height=12, spp=2):
    """smallpt_scene's arguments to build_scene, taken as it calls it."""
    import types

    from gdpt_tpu_torch.examples import small_gdpt

    calls = []
    monkeypatch.setattr(small_gdpt, "build", types.SimpleNamespace(
        build_scene=lambda *args, **kw: calls.append((args, kw))))
    small_gdpt.smallpt_scene(width, height, spp)
    monkeypatch.undo()
    (camera, materials, shapes, lights), kw = calls[0]
    return camera, materials, shapes, lights, kw["options"]


def _description(camera, materials, shapes, lights, options):
    """The same values as a benchmark scene description."""
    from gdpt_tpu_torch.scene import filters
    from gdpt_tpu_torch.scene import model as M

    def material(m):
        if isinstance(m, M.Lambertian):
            return tuple(np.asarray(m.reflectance, np.float64))
        if isinstance(m, M.DisneyMetal):
            assert m.anisotropic == 0.0
            return {"type": "disneymetal", "base_color": tuple(m.base_color),
                    "roughness": m.roughness}
        assert isinstance(m, M.RoughDielectric)
        assert (m.specular_reflectance, m.specular_transmittance) == (1.0, 1.0)
        return {"type": "roughdielectric", "roughness": m.roughness, "int_ior": m.eta,
                "ext_ior": 1.0}

    def shape(s):
        assert isinstance(s, M.Sphere)
        light = lights[s.area_light_id].intensity if s.area_light_id >= 0 else None
        return {"center": tuple(s.center), "radius": s.radius, "material": s.material_id,
                "emitter": light}

    assert camera.filter_kind == filters.FILTER_BOX
    return {
        "camera": {"cam_to_world": camera.cam_to_world, "fov": camera.fov,
                   "width": camera.width, "height": camera.height, "filter": "box",
                   "filter_param": camera.filter_param},
        "materials": [material(m) for m in materials],
        "shapes": [shape(s) for s in shapes],
        "options": {"integrator": options.integrator, "spp": options.samples_per_pixel,
                    "max_depth": options.max_depth, "rr_depth": options.rr_depth},
    }


def test_spheres_metal_and_glass_parse_to_the_scene_in_code(tmp_path, monkeypatch):
    from gdpt_tpu_torch import convert
    from gdpt_tpu_torch.scene import build, parser
    from gdpt_tpu_torch.scene import model as M

    camera, materials, shapes, lights, options = _smallpt_parts(monkeypatch)
    kinds = {type(m) for m in materials} | {type(s) for s in shapes} | {type(x) for x in lights}
    assert kinds >= {M.Sphere, M.DisneyMetal, M.RoughDielectric, M.DiffuseAreaLight}
    assert (materials[3].roughness, materials[4].roughness, materials[4].eta) == (0.02, 0.02, 1.5)
    desc = _description(camera, materials, shapes, lights, options)
    path = xml_writer.write_scene(str(tmp_path), desc)
    xml = open(path).read()
    for form in ('<shape type="sphere">', '<bsdf type="disneymetal"',
                 '<bsdf type="roughdielectric"', '<float name="extIOR" value="1.0"/>'):
        assert form in xml
    got = parser.parse_scene(path)[0]
    own = build.build_scene(camera, materials, shapes, lights, options=options)
    assert got.static == own.static
    for i, (a, b) in enumerate(zip(convert.tree_leaves(got.device),
                                   convert.tree_leaves(own.device), strict=True)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f"leaf {i}"


def _cornell(film=4):
    return session.describe(dict(spec.load_json("configs", "cbox_512_path"),
                                 width=film, height=film))


@pytest.mark.parametrize("entry,match", [
    ({"type": "roughplastic", "roughness": 0.1}, "material 4 "),
    ({"type": "disneymetal", "base_color": (1.0, 1.0, 1.0)}, "material 4 "),
    ({"type": "roughdielectric", "roughness": 0.02, "int_ior": 1.5, "ext_ior": 1.0,
      "alpha": 0.1}, "material 4 "),
    ((0.5, 0.5), "material 4 "),
    ({"center": (0.0, 0.0, 0.0), "radius": 1.0, "material": 0}, "shape 8 "),
    ({"positions": np.zeros((3, 3)), "material": 0, "emitter": None}, "shape 8 "),
    ({"kind": "rectangle", "material": 0, "emitter": None}, "shape 8 "),
])
def test_unknown_forms_raise(entry, match, tmp_path):
    desc = _cornell()
    if match.startswith("material"):
        desc["materials"] = [*desc["materials"], entry]
    else:
        desc["shapes"] = [*desc["shapes"], entry]
    with pytest.raises(ValueError, match=match):
        xml_writer.write_scene(str(tmp_path / "scene"), desc)


def test_a_config_names_its_check(tmp_path):
    """A copy of the benchmark with two new configs: one whose check names
    a module of its own, found as checks/<module>.py; one without, held by
    its integrator's check."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.load_spec()
    cfg = spec.load_json("configs", "cbox_512_gradpath")
    own = dict(cfg, check=dict(cfg["check"], module="spheres_gradpath"))
    for name, c in (("with_check", own), ("without_check", cfg)):
        (tmp_path / f"benchmark/configs/{name}.json").write_text(json.dumps(c))
        b["configs"].append(dict(b["configs"][0], name=name,
                                 file=f"benchmark/configs/{name}.json"))
        b["workloads"].append({"name": f"{name}.frames_4spp", "config": name,
                               "traffic": "frames_4spp", "chips": 1, "why": "a test cell"})
    (tmp_path / "benchmark/checks/spheres_gradpath.py").write_text(
        "def compare(run):\n    return {}\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec_ = spec.load_spec(tmp_path)
    check = spec.Cell(spec_, "with_check.frames_4spp", tmp_path).check()
    assert check.__file__ == str(tmp_path / "benchmark/checks/spheres_gradpath.py")
    check = spec.Cell(spec_, "without_check.frames_4spp", tmp_path).check()
    assert check.__file__ == str(tmp_path / "benchmark/checks/gradpath.py")
    assert callable(check.compare)
