"""The port's host BVH (gdpt_tpu_torch/accel/bvh.py) against gdpt_tpu's.

The numpy builder is deterministic and is held array-for-array equal to
gdpt_tpu.accel.bvh._build_bvh_numpy on the same boxes (numpy, seeded).
The native builder (csrc/bvh_builder.cpp, built with g++ at first use) is
held to validity: every primitive in exactly one leaf, every child box
inside its parent's, miss links consistent, and ray casts through its
tree equal to brute force. Also: the builder that ran is recorded, a
missing compiler raises for builder="native" and is not hidden, and
build_scene fills the Geometry.bvh_* fields.

`icosphere` and `icosphere_box` build this slice's test scenes with
either package's modules; the other test_torch_* files import them.
"""

import shutil

import numpy as np
import pytest
import torch

from gdpt_tpu.accel import bvh as jbvh
from gdpt_tpu_torch.accel import bvh as tbvh
from gdpt_tpu_torch.accel import native_build

from test_torch_packet import _brute, _rays, _soup, one_thread  # noqa: F401 (fixture)


def icosphere(level, center, radius):
    """Icosahedron subdivided `level` times: (positions, indices)."""
    p = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0], [0, -1, p], [0, 1, p],
                  [0, -1, -p], [0, 1, -p], [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(level):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        ab, bc, ca = inv.reshape(3, -1) + len(v)
        v = np.concatenate([v, mid])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)])
    return v * radius + np.asarray(center, np.float64), f


def icosphere_box(presets, M, build, xf, width, height, spp, level=2, max_depth=-1,
                  n_spheres=0, **build_kw):
    """The Cornell box's walls, light and camera around one icosphere
    (20 * 4^level triangles) and n_spheres analytic spheres, built with
    one package's own modules. Lambertian throughout."""
    quads = presets._mesh_from_quads
    materials = [M.Lambertian(presets.WHITE), M.Lambertian(presets.RED),
                 M.Lambertian(presets.GREEN), M.Lambertian(np.array([0.78, 0.78, 0.78]))]
    shapes = [
        quads([((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2))], material_id=0),
        quads([((556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0))],
              material_id=0),
        quads([((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2))],
              material_id=0),
        quads([((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2))], material_id=2),
        quads([((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0))],
              material_id=1),
    ]
    pos, idx = icosphere(level, (368.0, 100.0, 351.0), 100.0)
    shapes.append(M.TriangleMesh(positions=pos, indices=idx, material_id=0))
    for i in range(n_spheres):
        shapes.append(M.Sphere(
            center=np.array([60.0 + 40.0 * i, 40.0 + 30.0 * (i % 3), 120.0 + 30.0 * i]),
            radius=28.0, material_id=1 + i % 2))
    shapes.append(quads([((343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332),
                          (213, 548.7, 227))], material_id=3, area_light_id=0))
    lights = [M.DiffuseAreaLight(shape_id=len(shapes) - 1, intensity=presets.LIGHT_RGB)]
    cam = M.Camera(cam_to_world=xf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
                   fov=39.3077, width=width, height=height, filter_kind=2, filter_param=0.5)
    opts = M.RenderOptions(integrator="path", samples_per_pixel=spp, max_depth=max_depth)
    return build.build_scene(cam, materials, shapes, lights, options=opts, **build_kw)


def port_box(*args, **kw):
    from gdpt_tpu_torch.core import transform as xf
    from gdpt_tpu_torch.scene import build, presets
    from gdpt_tpu_torch.scene import model as M

    return icosphere_box(presets, M, build, xf, *args, **kw)


def reference_box(*args, **kw):
    from gdpt_tpu.core import transform as xf
    from gdpt_tpu.scene import build, presets
    from gdpt_tpu.scene import model as M

    return icosphere_box(presets, M, build, xf, *args, **kw)


def _boxes(case):
    """(tri v0, v1, v2, sphere centers, radii) of a named soup."""
    if case == "soup":
        return (*_soup(900, seed=5), None, None)
    if case == "spheres":
        rng = np.random.default_rng(3)
        return (*_soup(300, seed=4), rng.uniform(-8, 8, (20, 3)), rng.uniform(0.2, 1.5, 20))
    if case == "coincident":  # equal centroids: the median fallback
        v0, v1, v2 = _soup(1, seed=6)
        return (np.repeat(v0, 40, 0), np.repeat(v1, 40, 0), np.repeat(v2, 40, 0), None, None)
    pos, idx = icosphere(3, (0, 0, 0), 5.0)
    return (pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]], None, None)


def _reference_numpy(v0, v1, v2, sc, sr):
    sc = np.zeros((0, 3)) if sc is None else np.asarray(sc, np.float64)
    sr = np.zeros(0) if sr is None else np.asarray(sr, np.float64)
    return jbvh._build_bvh_numpy(*jbvh._centroids_bounds(
        np.asarray(v0, np.float64), np.asarray(v1, np.float64), np.asarray(v2, np.float64),
        sc, sr))


def _assert_same_arrays(got, ref):
    for name, a, b in zip(jbvh.BVHArrays._fields, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", ["soup", "spheres", "coincident", "icosphere"])
def test_numpy_builder_equals_reference(case):
    boxes = _boxes(case)
    got = tbvh.build_bvh(*boxes, builder="numpy")
    assert got.builder == "numpy"
    _assert_same_arrays(got, _reference_numpy(*boxes))


def test_presplit_refs_and_bvh_over_refs_equal_reference():
    v0, v1, v2 = _soup(300, seed=13)
    got = tbvh.presplit_refs(v0, v1, v2, budget_factor=1.0)
    ref = jbvh.presplit_refs(v0, v1, v2, budget_factor=1.0)
    assert got[0].shape[0] > 300  # splits happened
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    arr = tbvh.build_bvh_over_refs(got[1], got[2], builder="numpy")
    bmin, bmax = np.asarray(ref[1], np.float64), np.asarray(ref[2], np.float64)
    _assert_same_arrays(arr, jbvh._build_bvh_numpy(bmin, bmax, 0.5 * (bmin + bmax)))


def _check_valid_tree(arr, prim_bmin, prim_bmax):
    n_nodes = arr.count.shape[0]
    n = prim_bmin.shape[0]
    leaves = arr.count > 0
    assert sorted(arr.prim_order.tolist()) == list(range(n))
    # Leaves tile prim_order without gap or overlap.
    slots = np.concatenate([np.arange(f, f + c) for f, c in
                            zip(arr.first[leaves], arr.count[leaves])])
    assert sorted(slots.tolist()) == list(range(n))
    assert (arr.count <= tbvh.LEAF_SIZE).all()
    assert arr.miss[0] == n_nodes
    for i in range(n_nodes):
        assert i < arr.miss[i] <= n_nodes
        if leaves[i]:
            assert arr.miss[i] == i + 1
            p = arr.prim_order[arr.first[i]: arr.first[i] + arr.count[i]]
            assert (prim_bmin[p] >= arr.bbox_min[i] - 1e-5).all()
            assert (prim_bmax[p] <= arr.bbox_max[i] + 1e-5).all()
        else:
            left, right = i + 1, arr.miss[i + 1]
            assert arr.miss[right] == arr.miss[i]
            for c in (left, right):
                assert (arr.bbox_min[c] >= arr.bbox_min[i]).all()
                assert (arr.bbox_max[c] <= arr.bbox_max[i]).all()


@pytest.mark.parametrize("case", ["soup", "spheres", "icosphere"])
def test_native_builder_is_valid(case):
    if shutil.which(native_build.cxx_name()) is None:
        pytest.skip("no C++ compiler on this host")
    boxes = _boxes(case)
    arr = tbvh.build_bvh(*boxes, builder="native")
    assert arr.builder == "native"
    v0, v1, v2, sc, sr = boxes
    sc = np.zeros((0, 3)) if sc is None else sc
    sr = np.zeros(0) if sr is None else sr
    bmin, bmax, _ = tbvh._centroids_bounds(*(np.asarray(a, np.float64) for a in (v0, v1, v2)),
                                           sc, sr)
    _check_valid_tree(arr, bmin, bmax)


@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_builders_cast_rays_like_brute_force(builder):
    """Rays through either builder's tree (packet table, plain walk) hit
    what brute force over the soup hits, with the same t."""
    if builder == "native" and shutil.which(native_build.cxx_name()) is None:
        pytest.skip("no C++ compiler on this host")
    from gdpt_tpu_torch.accel import packet_trace as tpt
    from gdpt_tpu_torch.core.soa import V3

    v0, v1, v2 = _soup(700, seed=9)
    e1, e2 = v1 - v0, v2 - v0
    arr = tbvh.build_bvh(v0, v1, v2, builder=builder)
    tab = tpt.build_packet_table(*arr[:6], *(a.astype(np.float32) for a in (v0, e1, e2)))
    org, d = _rays(1024, seed=10)
    v3 = lambda a: V3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))  # noqa: E731
    t, prim, _, _, _ = tpt.intersect_packet(tab, v3(org), v3(d), 1e-4, 1e9)
    bt, bp, unique = _brute(tab.geo9.numpy(), org, d)
    assert unique.all() and 0.1 < (bp >= 0).mean() < 1.0
    np.testing.assert_array_equal(prim.numpy(), bp)
    np.testing.assert_array_equal(t.numpy()[bp >= 0], bt[bp >= 0])


def test_default_builder_is_recorded_and_missing_compiler_is_not_hidden(monkeypatch, tmp_path):
    v0, v1, v2 = _soup(50, seed=1)
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    monkeypatch.setattr(tbvh, "_lib", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)  # nothing built before
    assert tbvh.build_bvh(v0, v1, v2).builder == "numpy"
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        tbvh.build_bvh(v0, v1, v2, builder="native")
    with pytest.raises(ValueError):
        tbvh.build_bvh(v0, v1, v2, builder="embree")
    with pytest.raises(ValueError):
        tbvh.build_bvh(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)))


@pytest.mark.parametrize("how", ["above_threshold", "force_bvh"])
def test_build_scene_fills_bvh_fields(how):
    from gdpt_tpu_torch.scene import presets

    if how == "force_bvh":
        from gdpt_tpu_torch.core import transform as xf
        from gdpt_tpu_torch.scene import build
        from gdpt_tpu_torch.scene import model as M

        mesh = M.TriangleMesh(positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]],
                                                 np.float64),
                              indices=np.array([[0, 1, 2], [1, 3, 2]]), material_id=0)
        cam = M.Camera(cam_to_world=xf.look_at([0, 0, -3], [0, 0, 0], [0, 1, 0]), fov=45.0,
                       width=4, height=4)
        scene = build.build_scene(cam, [M.Lambertian(0.5)], [mesh], [], force_bvh=True,
                                  bvh_builder="numpy")
        assert presets.cornell_box(4, 4).static.use_brute_force
    else:
        scene = port_box(8, 8, 1, level=2, bvh_builder="numpy")
    g = scene.device.geom
    assert not scene.static.use_brute_force and scene.bvh_builder == "numpy"
    v0 = g.tri_v0.numpy().astype(np.float64)
    ref = _reference_numpy(v0, v0 + g.tri_e1.numpy(), v0 + g.tri_e2.numpy(), None, None)
    # The scene's f32 vertices round-trip through f64 exactly for the
    # boxes; the tree is built from the f64 originals, so compare shape
    # and structure, and the boxes to f32 rounding.
    assert g.bvh_count.shape == ref.count.shape
    np.testing.assert_array_equal(np.sort(g.bvh_prim_order.numpy()), np.arange(v0.shape[0]))
    np.testing.assert_allclose(g.bvh_bbox_min.numpy()[0], ref.bbox_min[0], rtol=1e-6)
    assert g.bvh_miss.dtype == torch.int32 and g.bvh_bbox_min.dtype == torch.float32
