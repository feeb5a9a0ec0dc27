"""The port's per-ray volumetric rungs with NEE, versions 4 and 5, against
gdpt_tpu's on the CPU, and the routes that serve them: checkpoint/resume
and the command line.

The rung renders are held to the reference's
render_samples(scene, trace_fn(static)) at the same seed at the path
gate of tests/test_torch_volpath.py (at least 99% of values within rtol
1e-3 / atol 1e-4, the mean within 0.1%): on presets.volpath_scene (v4;
v5 with the diffuse sphere; v5 at unbounded depth with HG g = 0.5; v5
with the medium inside a null sphere, so that shadow rays march across
the boundary) and on presets.medium_box cut to two level-1 icosphere
balls (v5 on the BVH path: K3 on the packet table). The
tests/test_volpath.py checks are mirrored on the port's renders (v3 and
v4 agree within 10%, v4 is finite and nonnegative, v5 agrees with the
port's v6 on a constant grid within 9%), and the volpath_v5 golden
passes at tests/test_goldens.py's RMSE/mean < 0.05.

A v5 render resumed from a checkpoint of its first pass equals the
uninterrupted render bit for bit (both take one sample a pass here), and
a v5 scene written by scene/xml_writer.py renders through
python -m gdpt_tpu_torch to the same image as render.render.
"""

import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.integrators import volpath as tvp
from gdpt_tpu_torch.scene import presets as tpresets
from gdpt_tpu_torch.utils import checkpoint

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import gate
from test_torch_volpath_bvh import SMALL_BALLS
from test_torch_volpath_rungs import SEED, check_rung, reference_render

ROOT = Path(__file__).resolve().parents[1]

RUNGS = {
    4: dict(version=4, width=20, height=20, spp=3, max_depth=6),
    5: dict(version=5, width=20, height=20, spp=3, max_depth=6, with_diffuse_sphere=True),
    "5-deep": dict(version=5, width=16, height=16, spp=2, max_depth=-1, g=0.5,
                   with_diffuse_sphere=True),
    "5-null": dict(version=5, width=16, height=16, spp=2, max_depth=6, g=-0.4,
                   with_diffuse_sphere=True, null_boundary=True),
}


@pytest.mark.parametrize("rung", list(RUNGS), ids=str)
def test_rung_matches_reference(rung):
    for k in tvp.HOST_READS:
        tvp.HOST_READS[k] = 0
    img, rays = check_rung(**RUNGS[rung])
    assert tvp.HOST_READS["segment"] > tvp.HOST_READS["bounce"]
    assert np.isfinite(img).all() and (img >= 0).all()


def test_medium_box_rung_matches_reference():
    """v5 in the medium box (BVH path, K3 on the packet table): the
    icosphere balls stand in a grid medium inside a null box."""
    from gdpt_tpu.core import transform as jxf
    from gdpt_tpu.scene import build as jbuild
    from gdpt_tpu.scene import model as jmodel

    kw = dict(width=16, height=16, spp=2, balls=SMALL_BALLS, grid_res=16, max_depth=6,
              version=5, mean_density=0.01)
    js = tpresets.build_medium_box(jmodel, jbuild, jxf, **kw)
    ts = tpresets.medium_box(**kw)
    assert not ts.static.use_brute_force
    ja = reference_render(js, SEED)
    ta = trender.render(ts, seed=SEED, device="cpu")
    gate(ta, ja, float(ja.mean()))


def test_medium_box_rung_walks_agree():
    """v5 in the medium box through the 32-wide table (K3), the 16-wide
    one, and the 16-wide one walked by the dual kernel (K4): one image,
    one ray count (every walk is exact)."""
    ts = tpresets.medium_box(width=12, height=12, spp=1, balls=SMALL_BALLS, grid_res=8,
                             max_depth=4, version=5)
    a = trender.render(ts, seed=SEED, device="cpu", return_stats=True)
    for walk in (dict(packet_wide=16), dict(packet_wide=16, packet_dual=True)):
        b = trender.render(ts, seed=SEED, device="cpu", return_stats=True, **walk)
        np.testing.assert_array_equal(b[0], a[0])
        assert b[1] == a[1]


@pytest.fixture(scope="module")
def multi_bounce_renders():
    imgs = {}
    for ver, kw in [(3, {}), (4, {})]:
        sc = tpresets.volpath_scene(version=ver, width=24, height=24, spp=48, max_depth=6, **kw)
        imgs[ver] = trender.render(sc, seed=ver, device="cpu")
    return imgs


def test_v3_v4_same_transport(multi_bounce_renders):
    m3 = multi_bounce_renders[3].mean()
    m4 = multi_bounce_renders[4].mean()
    assert abs(m3 - m4) / m4 < 0.1


def test_v4_nonnegative_finite(multi_bounce_renders):
    img = multi_bounce_renders[4]
    assert np.isfinite(img).all() and (img >= 0).all()


def test_v5_matches_v6_on_constant_grid():
    """A constant-density grid through the port's delta tracking (v6)
    agrees with the port's closed-form v5."""
    kw = dict(width=20, height=20, spp=20, max_depth=6, with_diffuse_sphere=True)
    img5 = trender.render(tpresets.volpath_scene(version=5, **kw), seed=10, device="cpu")
    img6 = trender.render(tpresets.volpath_scene(version=6, hetero=True, **kw), seed=11,
                          device="cpu")
    assert abs(img5.mean() - img6.mean()) / img5.mean() < 0.09, (img5.mean(), img6.mean())


def golden_v5(device):
    """The volpath_v5 golden's render (tests/test_goldens.py) on `device`:
    its RMSE over the golden's mean absolute value."""
    from gdpt_tpu_torch.core import image as timage

    golden = timage.read_exr(str(ROOT / "tests" / "goldens" / "volpath_v5.exr"))
    img = trender.render(tpresets.volpath_scene(version=5, width=32, height=32, spp=32,
                                                max_depth=5, with_diffuse_sphere=True),
                         seed=42, device=device)
    scale = max(float(np.abs(golden).mean()), 1e-3)
    return float(np.sqrt(((img - golden) ** 2).mean())) / scale


def test_golden_volpath_v5():
    assert golden_v5("cpu") < 0.05


def test_v5_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """One sample a pass (MAX_RAYS_PER_PASS cut to the pixel count): the
    first pass checkpointed, the render resumed from it."""
    sc = tpresets.volpath_scene(version=5, width=8, height=8, spp=3, max_depth=4,
                                with_diffuse_sphere=True)
    monkeypatch.setattr(trender, "MAX_RAYS_PER_PASS", 64)
    path = str(tmp_path / "ck.npz")
    fp = checkpoint._fingerprint(sc, 3, SEED)
    captured = {}

    def first(acc, done):
        captured.setdefault("ck", (acc.copy(), done))

    straight = trender.render_samples(sc, tvp.trace_fn(sc.static), seed=SEED, on_chunk=first)
    acc, done = captured["ck"]
    assert done == 1 and acc.shape == (64, 3)
    checkpoint.save_checkpoint(path, acc, done, fp)
    resumed = checkpoint.render_with_checkpoints(sc, seed=SEED, every=1, path=path,
                                                 device="cpu")
    np.testing.assert_array_equal(resumed, straight)
    acc, done = checkpoint.load_checkpoint(path, fp, (64, 3))
    assert done == 3


def test_cli_renders_a_v5_scene_file(tmp_path):
    from gdpt_tpu_torch.core import image as timage
    from gdpt_tpu_torch.core import transform as txf
    from gdpt_tpu_torch.scene import model as tmodel
    from gdpt_tpu_torch.scene import xml_writer

    kw = dict(version=5, width=10, height=8, spp=2, max_depth=4, with_diffuse_sphere=True)
    writer = types.SimpleNamespace(build_scene=functools.partial(xml_writer.write_scene,
                                                                 str(tmp_path)))
    xml = tpresets.build_volpath_scene(tmodel, writer, txf, **kw)
    out = tmp_path / "v5.exr"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "gdpt_tpu_torch", str(xml), "-o", str(out),
                           "--device", "cpu", "--seed", "3"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    img = timage.read_exr(str(out))
    ref = trender.render(tpresets.volpath_scene(**kw), seed=3, device="cpu")
    np.testing.assert_array_equal(img, ref)
