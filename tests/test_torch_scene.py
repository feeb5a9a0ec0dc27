"""The port's scene tables against gdpt_tpu's, leaf by leaf.

Tolerance: exact for int and bool tables, rtol 1e-6 for floats (both
packages narrow the same float64 host values to float32, so in practice
the floats are equal too).
"""

import dataclasses

import jax
import numpy as np
import torch

from gdpt_tpu.accel import pallas_intersect as jpli
from gdpt_tpu.integrators import path_soa as jpath
from gdpt_tpu.scene import presets as jpresets
from gdpt_tpu_torch import convert
from gdpt_tpu_torch.integrators import path_soa as tpath
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.scene import presets as tpresets


def _assert_leaf(j, t, path):
    if isinstance(t, torch.Tensor):
        a, b = np.asarray(j), t.cpu().numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert j == t, path


def _assert_tree(j, t, path="", extra=()):
    """Every field of the port's tree equals the same-named reference field;
    `extra` names port-only fields, checked elsewhere."""
    if hasattr(t, "_fields"):
        for f in t._fields:
            if f not in extra:
                _assert_tree(getattr(j, f), getattr(t, f), f"{path}.{f}", extra)
    elif isinstance(t, tuple):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            _assert_tree(a, b, f"{path}[{i}]", extra)
    else:
        _assert_leaf(j, t, path)


def test_build_scene_leaf_by_leaf():
    js, ts = jpresets.cornell_box(16, 16), tpresets.cornell_box(16, 16)
    jl = jax.tree_util.tree_leaves(js.device)
    tl = convert.tree_leaves(ts.device)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        _assert_leaf(a, b, f"leaf {i}")
    _assert_tree(js.device, ts.device)
    assert dataclasses.asdict(js.static) == dataclasses.asdict(ts.static)


def test_scene_soa_leaf_by_leaf():
    js, ts = jpresets.cornell_box(16, 16), tpresets.cornell_box(16, 16)
    jsc, tsc = jpath.scene_soa_from_aos(js), tpath.scene_soa_from_aos(ts)
    _assert_tree(jsc, tsc, extra=("tri_soup", "sph_soup", "dual"))
    assert tsc.geom.dual is False  # the port's static walk flag (the reference reads an env switch)
    tri, sph = jpli.pack_soups(jsc.geom, js.static.n_tris, js.static.n_spheres)
    _assert_leaf(tri, tsc.geom.tri_soup, "tri_soup")
    _assert_leaf(sph, tsc.geom.sph_soup, "sph_soup")


def test_convert_renders_same_image():
    js = jpresets.cornell_box(16, 16, spp=2, max_depth=3)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.device)]
    carried = convert.scene_from_numpy(leaves, dataclasses.asdict(js.static), device="cpu")
    own = tpresets.cornell_box(16, 16, spp=2, max_depth=3)
    _assert_tree(own.device, carried.device)
    assert carried.static == own.static
    a = trender.render(carried, seed=5, device="cpu")
    b = trender.render(own, seed=5, device="cpu")
    np.testing.assert_array_equal(a, b)
