"""The port's entry points (gdpt_tpu_torch/entry.py) against the
reference's __graft_entry__.py, on the CPU.

entry()'s fn on its own args (the 32x32 cbox, 2 spp, depth 4: trace_path
over 1,024 lanes, each keyed by fold_in(PRNGKey(0), pixel)) against the
reference's jitted entry() lane by lane at the path gate of
tests/test_torch_path_perray.py (at least 99% of values within rtol 1e-3 /
atol 1e-4, the mean within 0.1%: the port casts through K1/K2's plain
versions where the reference walks in XLA). dryrun_multichip(4,
device="cpu") runs the reference's four sharded renders and asserts on a
mesh of [cpu] * 4, and a mesh of n entries has n entries.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch import entry

from test_torch_bench import reference_script
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import gate



def _reference_entry():
    return reference_script("__graft_entry__.py")


def test_entry_matches_reference_per_lane():
    import jax

    jfn, jargs = _reference_entry().entry()
    ref = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = entry.entry(device="cpu")
    dev_scene, xs, ys, pix = args
    assert xs.shape == ys.shape == pix.shape == (1024,)
    assert dev_scene.camera.sample_to_cam.device.type == "cpu"
    got = fn(*args)
    assert got.shape == ref.shape == (1024, 3)
    gate(got.numpy(), ref, float(ref.mean()))


def test_dryrun_multichip_on_cpu():
    entry.dryrun_multichip(4, device="cpu")


def test_dryrun_multichip_asserts_its_mesh(monkeypatch):
    from gdpt_tpu_torch.parallel import sharding

    seen = []
    real = sharding.make_mesh

    def spy(devices=None):
        seen.append(list(devices))
        return real(devices)

    monkeypatch.setattr(sharding, "make_mesh", spy)
    monkeypatch.setattr(sharding, "render_samples_sharded",
                        lambda *a, **k: np.zeros((16, 16, 3), np.float32))
    with pytest.raises(AssertionError):  # a black image fails the reference's assert
        entry.dryrun_multichip(2, device="cpu")
    assert seen == [[torch.device("cpu")] * 2]
