"""The gradient-domain cell's comparison on the CPU, without the card:

- the port's render.render of the benchmark's Cornell box (16x16, 2 spp,
  depth 6, three seeds) agrees with benchmark/reference/gradpath.py and
  poisson.py through checks/gradpath.compare, within the cell's limits;
- the reference's solve is a dense float64 solve of the same system, and
  the port's ops/poisson agrees with it;
- the control (the reference in bfloat16) and every fault come out not
  correct at a small film;
- the new files keep the benchmark's import rules.

Frames are rendered directly, not through session.run, so the suite can
run these in a process that has loaded JAX (tests/test_torch_bench_gradpath.py
collects them there too)."""

import math

import numpy as np
import pytest
import torch

from benchmark.checks import gradpath as check
from benchmark.harness import controls_gradpath, session, spec
from benchmark.reference import gradpath, poisson
from benchmark.tests.test_bench_isolation import _imports

CELL = "cbox_512_gradpath.frames_4spp"
NEW_FILES = ("reference/gradpath.py", "reference/poisson.py", "checks/gradpath.py",
             "harness/controls_gradpath.py", "metrics/gdpt.bounce_host_ms_per_msample.py",
             "metrics/gdpt.solve_ms_per_frame.py", "metrics/gdpt.fixed_ms_per_frame.py")


def _cell_cfg(film):
    cfg = dict(spec.Cell(spec.load_spec(), CELL).config)
    cfg["width"] = cfg["height"] = film
    return cfg


def _scene(cfg, tmp_path):
    """The cell's scene at cfg's film, written by the frozen builder and
    read by the port's own front end, with its description."""
    from benchmark.scenes import xml_writer
    from gdpt_tpu_torch.scene import parser

    desc = session.describe(cfg)
    xml_writer.write_scene(str(tmp_path / "scene"), desc)
    return parser.parse_scene(str(tmp_path / "scene" / "scene.xml"))[0], desc


def _ctx(cfg, scene):
    from gdpt_tpu_torch.integrators import render

    def program(k, s):
        return render.render(scene, spp=k, seed=s, device="cpu", return_stats=True)

    return {"program": program, "cfg": cfg, "device": "cpu", "root": spec.ROOT}


def _compare(cfg, desc, spp, frames):
    return check.compare(dict(desc=desc, cfg=cfg, frames=frames, device="cpu", spp=spp))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 17, 3 * 2 ** 32 + 5])
def test_program_agrees_with_the_reference(seed, tmp_path):
    cfg = _cell_cfg(16)
    assert (cfg["max_depth"], cfg["integrator"]) == (6, "gradpath")
    scene, desc = _scene(cfg, tmp_path)
    img, rays = _ctx(cfg, scene)["program"](2, session.frame_seed(seed, 0))
    assert img.shape == (16, 16, 3) and rays > 5 * 16 * 16 * 2
    c = _compare(cfg, desc, 2, [(0, session.frame_seed(seed, 0), img)])
    assert all(v["value"] <= v["limit"] for v in c.values()), c
    assert c["off_share"]["value"] == 0.0, c


def _dense_laplacian(n):
    lap = np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
    lap[0, 1] = lap[-1, -2] = 2.0  # the border reflects
    return lap


def test_reference_solve_is_a_dense_solve():
    """(alpha - L) f = alpha u - div g solved densely on an 8x8 image, with
    the DC restore: the DCT's constant mode is the data term's, so the
    dense solution moves by (dc(u) - dc(rhs) / alpha) / (4 (w-1)(h-1))."""
    rng = np.random.default_rng(5)
    h = w = 8
    alpha = 0.04
    u, gx, gy = rng.random((h, w, 3)), rng.normal(size=(h, w, 3)), rng.normal(size=(h, w, 3))
    a = alpha * np.eye(h * w) - (np.kron(np.eye(h), _dense_laplacian(w))
                                 + np.kron(_dense_laplacian(h), np.eye(w)))
    div = poisson.divergence(torch.tensor(gx), torch.tensor(gy)).numpy()
    rhs = alpha * u - div
    dense = np.stack([np.linalg.solve(a, rhs[..., c].ravel()).reshape(h, w)
                      for c in range(3)], axis=-1)
    edge = np.ones(w)
    edge[1:-1] = 2.0
    weight = np.outer(edge, edge)[..., None]
    dense += ((weight * u).sum((0, 1)) - (weight * rhs).sum((0, 1)) / alpha) / (
        4.0 * (w - 1) * (h - 1))
    np.testing.assert_allclose(poisson.solve(u, gx, gy, alpha), dense, rtol=0, atol=1e-10)


def test_divergence_has_the_forks_border_factors():
    gx = torch.arange(1.0, 6.0, dtype=torch.float64).reshape(1, 5, 1)
    gy = torch.zeros_like(gx)
    assert poisson.divergence(gx, gy)[0, :, 0].tolist() == [-2.0, 1.0, 1.0, 1.0, -10.0]


def test_dct1_matrix_is_its_own_inverse_up_to_its_scale():
    m = poisson.dct1_matrix(9)
    np.testing.assert_allclose((m @ m).numpy(), 16.0 * np.eye(9), atol=1e-12)
    assert m[3, 0].item() == 1.0 and m[3, 8].item() == math.cos(3 * math.pi)


def test_port_solve_agrees_with_the_reference():
    from gdpt_tpu_torch.ops import poisson as port

    rng = np.random.default_rng(11)
    u = rng.random((64, 64, 3)) * 4.0
    gx, gy = rng.normal(size=(64, 64, 3)) * 0.3, rng.normal(size=(64, 64, 3)) * 0.3
    ref = poisson.solve(u, gx, gy, 0.04)
    got = port.screened_poisson_solve(*(torch.tensor(a, dtype=torch.float32)
                                        for a in (u, gx, gy)), 0.04).numpy()
    # float32 against float64: a few ulps of the image's scale.
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def test_reference_assembles_the_gradients_as_the_port():
    from gdpt_tpu_torch.ops import poisson as port

    rng = np.random.default_rng(3)
    bufs = [rng.normal(size=(6, 5, 3)) for _ in range(4)]
    ref = gradpath.assemble(*bufs)
    got = port.assemble_gradients(*(torch.tensor(b) for b in bufs))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g.numpy())


@pytest.mark.parametrize("frame", ["control", *sorted(controls_gradpath.FAULTS)])
def test_control_and_faults_fail(frame, tmp_path):
    cfg = _cell_cfg(16)
    spp = int(spec.Cell(spec.load_spec(), CELL).traffic["spp_per_frame"])
    scene, desc = _scene(cfg, tmp_path)
    ctx = _ctx(cfg, scene)
    fn = controls_gradpath.control if frame == "control" else controls_gradpath.FAULTS[frame]
    fn(ctx, spp, session.frame_seed(77, -1))  # the warm frame
    seed = session.frame_seed(77, 0)
    out, _ = fn(ctx, spp, seed)
    c = _compare(cfg, desc, spp, [(0, seed, out)])
    assert any(v["value"] > v["limit"] for v in c.values()), (frame, c)


def test_mix_keeps_the_mean_and_moves_the_differences(tmp_path):
    """mix keeps a frame's mean within its limit: only the share off and
    the finite differences can catch it."""
    cfg = _cell_cfg(16)
    scene, desc = _scene(cfg, tmp_path)
    seed = session.frame_seed(5, 0)
    out, _ = controls_gradpath.mix(_ctx(cfg, scene), 4, seed)
    c = _compare(cfg, desc, 4, [(0, seed, out)])
    assert c["mean_gap"]["value"] <= c["mean_gap"]["limit"], c
    assert c["grad_gap"]["value"] > c["grad_gap"]["limit"], c


def test_reference_renders_lambertian_gradpath_scenes_only():
    desc = session.describe(_cell_cfg(4))
    gradpath.check_lambertian(desc)
    with pytest.raises(ValueError, match="Lambertian"):
        gradpath.check_lambertian(dict(desc, materials=[*desc["materials"],
                                                         {"kind": "roughplastic"}]))
    from benchmark.reference import scene

    rs = scene.build(dict(desc, options=dict(desc["options"], integrator="path")))
    with pytest.raises(ValueError, match="gradpath"):
        gradpath.render_gradpath(rs, 1, 0)


@pytest.mark.parametrize("name", NEW_FILES)
def test_new_files_keep_the_import_rules(name):
    """No JAX and nothing of the JAX package anywhere; the reference and
    the check import nothing of the program either."""
    path = spec.BENCH / name
    names = set(_imports(path))
    assert not names & session.FORBIDDEN, path
    if name.startswith(("reference/", "checks/")):
        assert "gdpt_tpu_torch" not in names, path


@pytest.mark.parametrize("name", [CELL, "cbox_512_path.frames_256spp"])
def test_new_cells_resolve(name):
    """Each new cell finds its config, traffic, check and readers by name;
    it reports setup_s and another end-to-end metric, and every per-layer
    metric it reports moves one of them."""
    cell = spec.Cell(spec.load_spec(), name)
    e2e = {m["name"] for m, _ in cell.readers(0)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cell.readers(1)
    assert per_layer and all(callable(r.read) for _, r in per_layer)
    assert all(m["moves"] in e2e for m, _ in per_layer)
    assert callable(cell.check().compare)
