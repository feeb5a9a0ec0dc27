"""Checkpoint/resume of the port (utils/checkpoint.py), mirroring
tests/test_checkpoint.py: a render that stopped part way resumes to the
uninterrupted image, and a checkpoint of another render, of another
shape or of a single-pass integrator is refused.

A resumed brute-force render sums its samples in other f32 passes than
the uninterrupted one, so it is held at the reference's atol 1e-6; a BVH
`path` render takes one sample a pass, so its resume is bit for bit.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch import convert
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.integrators import gdpt_soa, path_soa, render as R, volpath_soa
from gdpt_tpu_torch.scene import presets
from gdpt_tpu_torch.scene.build import scene_to
from gdpt_tpu_torch.utils import checkpoint

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)


def _partial_checkpoint(render_partial, path, fp):
    """Render only the first k samples, persist the raw accumulator as a
    checkpoint — the state a crash mid-render would have left behind."""
    captured = {}

    def capture(acc, done):
        captured["acc"], captured["done"] = acc.copy(), done

    render_partial(capture)
    checkpoint.save_checkpoint(path, captured["acc"], captured["done"], fp)
    return captured["done"]


def test_path_partial_resume_matches_uninterrupted(tmp_path):
    sc = presets.cornell_box(width=8, height=8, spp=8, max_depth=3)
    path = str(tmp_path / "ck.npz")
    fp = checkpoint._fingerprint(sc, 8, 0)
    done = _partial_checkpoint(lambda cb: path_soa.render_soa(sc, spp=4, seed=0, on_chunk=cb),
                               path, fp)
    assert done == 4
    resumed = checkpoint.render_with_checkpoints(sc, spp=8, seed=0, every=4, path=path,
                                                 device="cpu")
    straight = R.render(sc, spp=8, seed=0, device="cpu")
    np.testing.assert_allclose(resumed, straight, atol=1e-6)


def test_bvh_path_resume_is_bit_for_bit(tmp_path):
    sc = presets.cornell_box(width=8, height=8, spp=4, max_depth=3, force_bvh=True)
    path = str(tmp_path / "ck.npz")
    fp = checkpoint._fingerprint(sc, 4, 0)
    _partial_checkpoint(lambda cb: path_soa.render_soa(sc, spp=2, seed=0, on_chunk=cb), path, fp)
    resumed = checkpoint.render_with_checkpoints(sc, spp=4, seed=0, every=1, path=path,
                                                 device="cpu")
    straight = path_soa.render_soa(sc, spp=4, seed=0, wavefront=False)
    np.testing.assert_array_equal(resumed, straight)
    acc, done = checkpoint.load_checkpoint(path, fp, (3, 64))
    assert done == 4 and acc.dtype == np.float64


def test_gradpath_partial_resume_matches_uninterrupted(tmp_path):
    sc = presets.cornell_box(width=8, height=8, spp=4, max_depth=3, integrator="gradpath")
    assert gdpt_soa.supports_soa_gdpt(sc)
    path = str(tmp_path / "ck.npz")
    fp = checkpoint._fingerprint(sc, 4, 0)
    _partial_checkpoint(lambda cb: gdpt_soa.render_gradpath_soa(sc, spp=2, seed=0, on_chunk=cb),
                        path, fp)
    resumed = checkpoint.render_with_checkpoints(sc, spp=4, seed=0, every=2, path=path,
                                                 device="cpu")
    straight = gdpt_soa.render_gradpath_soa(sc, spp=4, seed=0)
    np.testing.assert_allclose(resumed, straight, atol=1e-6)


def test_volpath_partial_resume_matches_uninterrupted(tmp_path):
    sc = presets.volpath_scene(version=6, width=8, height=8, spp=4, max_depth=3, hetero=True)
    assert volpath_soa.supports_soa_volpath(sc)
    path = str(tmp_path / "ck.npz")
    fp = checkpoint._fingerprint(sc, 4, 0)
    _partial_checkpoint(lambda cb: volpath_soa.render_volpath_soa(sc, spp=2, seed=0, on_chunk=cb),
                        path, fp)
    resumed = checkpoint.render_with_checkpoints(sc, spp=4, seed=0, every=2, path=path,
                                                 device="cpu")
    straight = volpath_soa.render_volpath_soa(sc, spp=4, seed=0)
    np.testing.assert_allclose(resumed, straight, atol=1e-6)


def test_stale_checkpoint_rejected(tmp_path):
    """A checkpoint from a different scene/seed/spp must be discarded."""
    sc = presets.cornell_box(width=8, height=8, spp=4, max_depth=3)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(path, np.full((3, 64), 1e9), 2, fingerprint="deadbeef")
    with pytest.warns(UserWarning, match="fingerprint mismatch"):
        out = checkpoint.render_with_checkpoints(sc, spp=4, seed=0, every=2, path=path,
                                                 device="cpu")
    straight = R.render(sc, spp=4, seed=0, device="cpu")
    np.testing.assert_allclose(out, straight, atol=1e-6)


def test_wrong_shape_checkpoint_rejected(tmp_path):
    sc = presets.cornell_box(width=8, height=8, spp=4, max_depth=3)
    path = str(tmp_path / "ck.npz")
    fp = checkpoint._fingerprint(sc, 4, 0)
    checkpoint.save_checkpoint(path, np.zeros((3, 16)), 2, fingerprint=fp)
    with pytest.warns(UserWarning, match="shape"):
        acc, done = checkpoint.load_checkpoint(path, fp, (3, 64))
    assert acc is None and done == 0


def test_corrupt_checkpoint_rejected(tmp_path):
    path = tmp_path / "ck.npz"
    path.write_bytes(b"PK\x03\x04 not a whole archive")
    with pytest.warns(UserWarning, match="unreadable"):
        acc, done = checkpoint.load_checkpoint(str(path), "fp", (3, 64))
    assert acc is None and done == 0


def test_aux_integrator_rejected(tmp_path):
    sc = presets.cornell_box(width=8, height=8, integrator="depth")
    with pytest.raises(ValueError, match="single-pass"):
        checkpoint.render_with_checkpoints(sc, path=str(tmp_path / "c.npz"), device="cpu")


def test_per_ray_volpath_rung_raises(tmp_path):
    """A per-ray rung (version 3), which raised NotImplementedError before
    it was ported, now renders with checkpoints: the (n_pix, 3)
    accumulator of render_samples, and the image of render.render."""
    sc = presets.volpath_scene(version=3, width=8, height=8, spp=2)
    img = checkpoint.render_with_checkpoints(sc, path=str(tmp_path / "c.npz"), device="cpu")
    np.testing.assert_array_equal(img, R.render(sc, device="cpu"))
    acc, done = checkpoint.load_checkpoint(str(tmp_path / "c.npz"),
                                           checkpoint._fingerprint(sc, 2, 0), (64, 3))
    assert done == 2 and acc is not None


def test_unwritable_checkpoint_raises(tmp_path):
    """A checkpoint that cannot be written stops the render; it does not
    go on without one."""
    sc = presets.cornell_box(width=8, height=8, spp=2, max_depth=2)
    with pytest.raises(OSError):
        checkpoint.render_with_checkpoints(sc, path=str(tmp_path / "no" / "c.npz"),
                                           device="cpu")


def test_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.render_with_checkpoints(presets.cornell_box(4, 4, spp=1),
                                           path=str(tmp_path / "c.npz"))


def test_fingerprint_detects_single_element_edit():
    """A few changed floats inside a large buffer must perturb the digest."""
    sc = presets.cornell_box(width=8, height=8, spp=2, max_depth=3)
    fp0 = checkpoint._fingerprint(sc, 4, 0)
    leaves = [x for x in convert.tree_leaves(sc.device) if isinstance(x, torch.Tensor)]
    big = max((x for x in leaves if x.is_floating_point()), key=lambda x: x.numel())

    def edit(t):
        if t is not big:
            return t
        t = t.clone()
        t.view(-1)[t.numel() // 2] += 1.0
        return t

    fp1 = checkpoint._fingerprint(sc._replace(device=soa.tree_map(edit, sc.device)), 4, 0)
    assert fp0 != fp1
    assert checkpoint._fingerprint(sc, 4, 1) != fp0 != checkpoint._fingerprint(sc, 8, 0)


def test_fingerprint_does_not_depend_on_the_device():
    """The digest reads every leaf on the host: the scene and its copy
    carried by scene_to (here to the CPU; chip_smoke.py phase 31 carries
    it to the card) give the same one, so a checkpoint written by a render
    on one device resumes a render on another."""
    sc = presets.cornell_box(width=8, height=8, spp=2, max_depth=3)
    moved = scene_to(sc, "cpu")
    assert checkpoint._fingerprint(moved, 4, 0) == checkpoint._fingerprint(sc, 4, 0)
    copy = sc._replace(device=soa.tree_map(lambda t: t.clone(), sc.device))
    assert checkpoint._fingerprint(copy, 4, 0) == checkpoint._fingerprint(sc, 4, 0)
