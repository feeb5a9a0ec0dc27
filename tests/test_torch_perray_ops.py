"""The per-ray stack of the port (core/math.py, ops/microfacet.py,
ops/materials.py, ops/lights.py, ops/media.py, ops/intersect.py) against
jax.vmap of gdpt_tpu's per-ray functions, on the CPU.

Every function gets the same lanes, made with numpy from a seed (2,048
of them, never 3, so that a per-lane scalar cannot broadcast silently
against a vector). Tolerances are tests/test_torch_materials.py's:
every output finite; values within rtol 1e-4 / atol 1e-6 on at least
99.9% of lanes; sampled directions, etas and roughnesses within atol
1e-4 on at least 99.9% of the lanes valid in both; integer outputs
(light ids, medium ids, valid flags) equal on 99.9% of lanes. A share,
not every lane, because a choice that compares a random number with a
float (a lobe, a Fresnel branch) flips on one ulp of XLA against torch.

The casts: the port's intersect runs the port's kernels' plain versions
(K1 on a brute-force scene, K3 on a BVH scene's packet table), the
reference's its XLA walks (brute force, or its own BVH). The hit
distance t differs by at most 4 ulp on 99.9% of hitting lanes, the
primitive id is compared only where t is unique (coplanar ties flip),
and the vertex built from the hit agrees at the gate above.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.core import math as tgm
from gdpt_tpu_torch.ops import lights as tlgt
from gdpt_tpu_torch.ops import materials as tmat
from gdpt_tpu_torch.ops import media as tmed
from gdpt_tpu_torch.ops import microfacet as tmf
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

N = 2048
SHARE = 0.999
RTOL, ATOL = 1e-4, 1e-6
ALL_KINDS = [
    M.MAT_LAMBERTIAN, M.MAT_ROUGH_PLASTIC, M.MAT_ROUGH_DIELECTRIC,
    M.MAT_DISNEY_DIFFUSE, M.MAT_DISNEY_METAL, M.MAT_DISNEY_GLASS,
    M.MAT_DISNEY_CLEARCOAT, M.MAT_DISNEY_SHEEN, M.MAT_DISNEY_BSDF,
]


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(c) for c in x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _vmap(fn, *args):
    import jax

    return _np(jax.vmap(fn)(*args))


def _unit(rng, n=N):
    d = rng.normal(size=(n, 3))
    return _f32(d / np.linalg.norm(d, axis=1, keepdims=True))


def _share(ok, mask=None):
    ok = ok.reshape(ok.shape[0], -1).all(axis=1)
    return ok[mask].mean() if mask is not None else ok.mean()


def close(got, ref, mask=None, rtol=RTOL, atol=ATOL):
    """The gate above, for a pair of arrays of the same shape."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        assert _share(got == ref, mask) >= SHARE
        return
    assert np.isfinite(got[mask] if mask is not None else got).all()
    assert _share(np.isclose(got, ref, rtol=rtol, atol=atol), mask) >= SHARE


# ---------------------------------------------------------------------------
# core/math, ops/microfacet, scene/camera
# ---------------------------------------------------------------------------


def test_math_matches_reference():
    from gdpt_tpu.core import math as jgm

    rng = np.random.default_rng(1)
    a, b, n = _unit(rng), _f32(rng.normal(size=(N, 3))), _unit(rng)
    n[:8] = [0.0, 0.0, -1.0]  # the coordinate system's degenerate guard
    uv = _f32(rng.random((N, 2)))
    frame = _vmap(jgm.make_frame, n)
    close(tgm.make_frame(_t(n)).numpy(), frame)
    close(tgm.dot(_t(a), _t(b)).numpy(), _vmap(jgm.dot, a, b))
    close(tgm.cross(_t(a), _t(b)).numpy(), _vmap(jgm.cross, a, b))
    close(tgm.normalize(_t(b), eps=1e-20).numpy(), _vmap(lambda v: jgm.normalize(v, 1e-20), b))
    close(tgm.to_local(_t(frame), _t(b)).numpy(), _vmap(jgm.to_local, frame, b))
    close(tgm.to_world(_t(frame), _t(b)).numpy(), _vmap(jgm.to_world, frame, b))
    close(tgm.sample_cos_hemisphere(_t(uv)).numpy(), _vmap(jgm.sample_cos_hemisphere, uv))
    close(tgm.sample_uniform_sphere(_t(uv)).numpy(), _vmap(jgm.sample_uniform_sphere, uv))


def test_microfacet_matches_reference():
    from gdpt_tpu.ops import microfacet as jmf

    rng = np.random.default_rng(2)
    v, h = _unit(rng), _unit(rng)
    c, eta = _f32(rng.uniform(-1, 1, N)), _f32(rng.uniform(0.6, 2.2, N))
    r, ax, ay = (_f32(rng.uniform(0.01, 1.0, N)) for _ in range(3))
    uv = _f32(rng.random((N, 2)))
    cases = [
        (tmf.fresnel_dielectric(_t(c), _t(eta)), _vmap(jmf.fresnel_dielectric, c, eta)),
        (tmf.gtr2(_t(c), _t(r)), _vmap(jmf.gtr2, c, r)),
        (tmf.gtr2_aniso(_t(h), _t(ax), _t(ay)), _vmap(jmf.gtr2_aniso, h, ax, ay)),
        (tmf.smith_masking_gtr2(_t(v), _t(r)), _vmap(jmf.smith_masking_gtr2, v, r)),
        (tmf.smith_masking_aniso(_t(v), _t(ax), _t(ay)),
         _vmap(jmf.smith_masking_aniso, v, ax, ay)),
        (tmf.sample_visible_normals(_t(v), _t(r), _t(uv)),
         _vmap(jmf.sample_visible_normals, v, r, uv)),
        (tmf.sample_visible_normals(_t(v), _t(r), _t(uv), _t(ax), _t(ay)),
         _vmap(jmf.sample_visible_normals, v, r, uv, ax, ay)),
        (tmf.sample_clearcoat_normal(_t(r * 0.1), _t(uv)),
         _vmap(jmf.sample_clearcoat_normal, r * 0.1, uv)),
        (tmf.gtr1_clearcoat(_t(c), _t(r * 0.1)), _vmap(jmf.gtr1_clearcoat, c, r * 0.1)),
        (tmf.reflect_over(_t(v), _t(h)), _vmap(jmf.reflect_over, v, h)),
    ]
    for i, (got, ref) in enumerate(cases):
        close(got.numpy(), ref, rtol=RTOL, atol=1e-5 if i >= 5 else ATOL)


@pytest.mark.parametrize("scene", ["volpath", "cbox"])
def test_camera_matches_reference(scene):
    """Primary rays (a Gaussian filter, the volpath scene's; a box
    filter, the Cornell box's) and the ray-differential helpers."""
    from gdpt_tpu.scene import camera as jcam
    from gdpt_tpu.scene import presets as jpresets
    from gdpt_tpu_torch.scene import camera as tcam

    make = dict(volpath=lambda p: p.volpath_scene(version=5, width=24, height=16, spp=1),
                cbox=lambda p: p.cornell_box(24, 16, 1))[scene]
    js, ts = make(jpresets), make(tpresets)
    st = ts.static
    rng = np.random.default_rng(8)
    screen = _f32(rng.random((N, 2)))
    org, d = tcam.sample_primary(ts.device.camera, st.width, st.height, st.filter_kind,
                                 st.filter_param, _t(screen))
    jorg, jd = _vmap(lambda s: jcam.sample_primary(js.device.camera, st.width, st.height,
                                                    st.filter_kind, st.filter_param, s), screen)
    close(org.numpy(), jorg)
    close(d.numpy(), jd, atol=1e-5)
    r, s, mc, rough, eta = (_f32(rng.uniform(lo, hi, N)) for lo, hi in
                            ((0, 1), (0, 0.1), (-2, 2), (0, 1), (1.1, 2)))
    for a, b in zip(tcam.init_ray_differential(24, 16), jcam.init_ray_differential(24, 16)):
        assert a.dtype == torch.float32 and a.item() == np.asarray(b).item()
    close(tcam.ray_diff_transfer(_t(r), _t(s), _t(mc)).numpy(),
          _vmap(jcam.ray_diff_transfer, r, s, mc))
    close(tcam.ray_diff_reflect(_t(r), _t(s), _t(mc), _t(rough)).numpy(),
          _vmap(jcam.ray_diff_reflect, r, s, mc, rough))
    close(tcam.ray_diff_refract(_t(r), _t(s), _t(mc), _t(eta), _t(rough)).numpy(),
          _vmap(jcam.ray_diff_refract, r, s, mc, eta, rough))


# ---------------------------------------------------------------------------
# ops/materials: the nine kinds' eval, pdf and sample, and gather_params
# ---------------------------------------------------------------------------


def _material_lanes(kind):
    """numpy lanes of one kind: params, din, dout, vertex fields, uv, w."""
    from gdpt_tpu_torch.ops import materials_soa

    rng = np.random.default_rng(100 + kind)
    gn = rng.normal(size=(N, 3))
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    sn = gn + 0.4 * rng.normal(size=(N, 3))
    sn /= np.linalg.norm(sn, axis=1, keepdims=True)
    gn = np.where(((gn * sn).sum(1) < 0)[:, None], -gn, gn)
    frame = tgm.make_frame(_t(_f32(sn))).numpy()
    params = dict(kind=np.full(N, kind, np.int32), eta=_f32(rng.uniform(1.05, 2.2, N)))
    for name in ("refl", "spec_refl", "spec_trans"):
        params[name] = _f32(rng.random((N, 3)))
    for name in materials_soa.MatParamsSoA._fields[5:]:
        params[name] = _f32(rng.random(N))
    vertex = dict(geom_normal=_f32(gn), frame=frame)
    return (params, _unit(rng), _unit(rng), vertex, _f32(rng.random((N, 2))),
            _f32(rng.random(N)))


def _vertex(pkg, n=N, **fields):
    """A PathVertex of `pkg` ("port" or "ref") from numpy fields; the
    others zero."""
    from gdpt_tpu.ops import intersect as jisect
    from gdpt_tpu_torch.ops import intersect as tisect

    shapes = dict(position=(3,), geom_normal=(3,), frame=(3, 3), st=(2,), uv=(2,))
    ints = ("shape_id", "prim_id", "material_id", "interior_medium_id", "exterior_medium_id")
    out = {}
    for f in tisect.PathVertex._fields:
        if f in fields:
            a = fields[f]
        elif f == "valid":
            a = np.ones(n, bool)
        else:
            a = np.zeros((n,) + shapes.get(f, ()), np.int32 if f in ints else np.float32)
        out[f] = a
    if pkg == "port":
        return tisect.PathVertex(**{k: _t(v) for k, v in out.items()})
    import jax.numpy as jnp

    return jisect.PathVertex(**{k: jnp.asarray(v) for k, v in out.items()})


_MAT = {}


def _materials(kind):
    if kind not in _MAT:
        import jax.numpy as jnp
        from gdpt_tpu.ops import materials as jmat

        params, din, dout, vf, uv, w = _material_lanes(kind)
        used = (kind,)
        tp = tmat.MatParams(**{k: _t(v) for k, v in params.items()})
        jp = jmat.MatParams(**{k: jnp.asarray(v) for k, v in params.items()})
        tv, jv = _vertex("port", **vf), _vertex("ref", **vf)
        ts = tmat.sample_bsdf(tp, _t(din), tv, _t(uv), _t(w), used)
        _MAT[kind] = dict(
            port=(tmat.eval_bsdf(tp, _t(din), _t(dout), tv, used).numpy(),
                  tmat.pdf_bsdf(tp, _t(din), _t(dout), tv, used).numpy(), _np(tuple(ts))),
            ref=(_vmap(lambda p, a, b, v: jmat.eval_bsdf(p, a, b, v, used), jp, din, dout, jv),
                 _vmap(lambda p, a, b, v: jmat.pdf_bsdf(p, a, b, v, used), jp, din, dout, jv),
                 _vmap(lambda p, a, v, u, x: tuple(jmat.sample_bsdf(p, a, v, u, x, used)),
                       jp, din, jv, uv, w)))
    return _MAT[kind]


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_material_eval_and_pdf_match_reference(kind):
    out = _materials(kind)
    for i in (0, 1):
        got, ref = out["port"][i], out["ref"][i]
        assert (got >= 0).all()
        close(got, ref)
    assert out["port"][1].max() > 0


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_material_sample_matches_reference(kind):
    (gd, ge, gr, gv), (rd, re, rr, rv) = _materials(kind)["port"][2], _materials(kind)["ref"][2]
    close(gv, rv)
    assert gv.mean() > 0.2
    both = gv & rv
    for got, ref in ((gd, rd), (ge, re), (gr, rr)):
        close(got, ref, both, rtol=0.0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(gd[gv], axis=1), 1.0, atol=1e-3)


def _material_boxes(**kw):
    from gdpt_tpu.core import transform as jxf
    from gdpt_tpu.scene import build as jbuild
    from gdpt_tpu.scene import model as jmodel

    return (tpresets.build_material_box(jmodel, jbuild, jxf, 8, 8, 1, **kw),
            tpresets.material_box(8, 8, 1, **kw))


@pytest.mark.parametrize("footprint", [False, True])
def test_gather_params_matches_reference(footprint):
    """Every slot of every material of the material box (an image
    texture on the back wall's colour and on the floor's roughness), at
    level 0 without a footprint and mip-filtered with one."""
    from gdpt_tpu.ops import materials as jmat

    js, ts = _material_boxes(image_px=32, seed=2)
    rng = np.random.default_rng(9)
    n_mat = int(ts.device.materials.kind.shape[0])
    fields = dict(material_id=rng.integers(-1, n_mat, N).astype(np.int32),
                  uv=_f32(rng.uniform(-0.2, 1.2, (N, 2))),
                  uv_screen_size=_f32(rng.uniform(0.0, 0.2, N) ** 2 if footprint else
                                      np.zeros(N)))
    got = tmat.gather_params(ts.device, ts.static, _vertex("port", **fields))
    ref = _vmap(lambda v: jmat.gather_params(js.device, js.static, v), _vertex("ref", **fields))
    for name, a, b in zip(tmat.MatParams._fields, got, ref):
        close(a.numpy(), b)
    assert np.ptp(got.refl.numpy()[fields["material_id"] == 0, 0]) > 0.05
    assert np.ptp(got.roughness.numpy()[fields["material_id"] == 5]) > 0.05


# ---------------------------------------------------------------------------
# ops/lights: selection, point sampling and pdfs, emission
# ---------------------------------------------------------------------------


def _volpath_pair(**kw):
    from gdpt_tpu.core import transform as jxf
    from gdpt_tpu.scene import build as jbuild
    from gdpt_tpu.scene import model as jmodel
    from gdpt_tpu_torch.core import transform as txf
    from gdpt_tpu_torch.scene import build as tbuild

    return (tpresets.build_volpath_scene(jmodel, jbuild, jxf, **kw),
            tpresets.build_volpath_scene(M, tbuild, txf, **kw))


@pytest.mark.parametrize("scene", ["material_box", "spheres"])
def test_lights_match_reference(scene):
    """The material box (a mesh light and an image envmap) and the volpath
    scene (two sphere lights; reference points inside and outside them)."""
    from gdpt_tpu.ops import lights as jlgt

    if scene == "material_box":
        js, ts = _material_boxes(image_px=16, env_px=16)
        ref_pt = _f32(np.random.default_rng(3).uniform(0, 550, (N, 3)))
    else:
        js, ts = _volpath_pair(version=5, width=8, height=8, spp=1, with_diffuse_sphere=True)
        ref_pt = _f32(np.random.default_rng(3).uniform(-4, 4, (N, 3)))
    rng = np.random.default_rng(4)
    uv, w, sw = _f32(rng.random((N, 2))), _f32(rng.random(N)), _f32(rng.random(N))
    jd, jst, td, tst = js.device, js.static, ts.device, ts.static

    lid = tlgt.sample_light_id(td, _t(w))
    close(lid.numpy(), _vmap(lambda x: jlgt.sample_light_id(jd, x), w))
    assert len(np.unique(lid.numpy())) == 2
    jl = lid.numpy()
    close(tlgt.light_pmf(td, lid).numpy(), _vmap(lambda i: jlgt.light_pmf(jd, i), jl))
    pos, nrm = tlgt.sample_point_on_light(td, tst, lid, _t(ref_pt), _t(uv), _t(sw))
    jpos, jnrm = _vmap(lambda i, p, a, b: jlgt.sample_point_on_light(jd, jst, i, p, a, b),
                       jl, ref_pt, uv, sw)
    close(pos.numpy(), jpos, rtol=1e-4, atol=1e-4)
    close(nrm.numpy(), jnrm, atol=1e-5)
    pdf = tlgt.pdf_point_on_light(td, tst, lid, pos, nrm, _t(ref_pt))
    close(pdf.numpy(), _vmap(lambda i, p, n, r: jlgt.pdf_point_on_light(jd, jst, i, p, n, r),
                             jl, jpos, jnrm, ref_pt))
    assert (pdf.numpy() > 0).mean() > 0.5
    view = _unit(rng)
    le = tlgt.emission_light(td, tst, lid, _t(view), 0.0, pos, nrm)
    close(le.numpy(), _vmap(lambda i, v, p, n: jlgt.emission_light(jd, jst, i, v, 0.0, p, n),
                            jl, view, jpos, jnrm))
    assert le.numpy().max() > 0
    sid = rng.integers(0, tst.n_shapes, N).astype(np.int32)
    fields = dict(shape_id=sid, position=jpos, geom_normal=jnrm)
    got = tlgt.emission_at_vertex(td, tst, _vertex("port", **fields), _t(view))
    close(got.numpy(), _vmap(lambda v, d: jlgt.emission_at_vertex(jd, jst, v, d),
                             _vertex("ref", **fields), view))
    if tst.has_envmap:
        dirs = _unit(rng)
        close(tlgt.envmap_emission(td, _t(dirs), 0.0).numpy(),
              _vmap(lambda d: jlgt.envmap_emission(jd, d, 0.0), dirs))


# ---------------------------------------------------------------------------
# ops/media: lookups, majorant, coefficients, phase functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("medium", ["homogeneous", "grid"])
def test_media_match_reference(medium):
    """The volpath scene's medium: homogeneous and isotropic, or a
    varying chromatic 16^3 density grid with an albedo grid and HG
    g = 0.6; points inside and outside the grid's bbox, lanes in the
    medium and in vacuum (-1)."""
    from gdpt_tpu.ops import media as jmed

    kw = dict(version=5, width=8, height=8, spp=1)
    if medium == "grid":
        kw.update(density=tpresets.medium_grid(16, 3, 0.8), albedo=tpresets.albedo_grid(16, 4),
                  g=0.6)
    js, ts = _volpath_pair(**kw)
    jd, jst, td, tst = js.device, js.static, ts.device, ts.static
    rng = np.random.default_rng(5)
    p = _f32(rng.uniform(-60, 60, (N, 3)))
    d = _unit(rng)
    d[:16, 1:] = 0.0  # axis-parallel rays (the slab test's 1e-20 guard)
    din = _unit(rng)
    mid = rng.integers(-1, 1, N).astype(np.int32)
    uv = _f32(rng.random((N, 2)))
    tp, tdir, tm = _t(p), _t(d), _t(mid)
    for name in ("get_sigma_s", "get_sigma_a"):
        got = getattr(tmed, name)(td, tst, tm, tp).numpy()
        close(got, _vmap(lambda m, x: getattr(jmed, name)(jd, jst, m, x), mid, p))
        assert got.max() > 0
    close(tmed.get_majorant(td, tst, tm, tp, tdir).numpy(),
          _vmap(lambda m, x, y: jmed.get_majorant(jd, jst, m, x, y), mid, p, d))
    new_dir = tmed.phase_sample(td, tst, tm, _t(din), _t(uv))
    jdir = _vmap(lambda m, a, b: jmed.phase_sample(jd, jst, m, a, b), mid, din, uv)
    close(new_dir.numpy(), jdir, atol=1e-5)
    for name in ("phase_eval", "phase_pdf"):
        close(getattr(tmed, name)(td, tst, tm, _t(din), _t(jdir)).numpy(),
              _vmap(lambda m, a, b: getattr(jmed, name)(jd, jst, m, a, b), mid, din, jdir))
    fields = dict(geom_normal=_unit(rng), interior_medium_id=rng.integers(-1, 2, N).astype(
        np.int32), exterior_medium_id=rng.integers(-1, 2, N).astype(np.int32))
    close(tmed.update_medium(_vertex("port", **fields), tdir, tm).numpy(),
          _vmap(lambda v, x, m: jmed.update_medium(v, x, m), _vertex("ref", **fields), d, mid))


# ---------------------------------------------------------------------------
# ops/intersect: casts through the port's kernels, vertex_from_hit
# ---------------------------------------------------------------------------


def _cast_scenes(kind):
    from gdpt_tpu.scene import presets as jpresets

    if kind == "brute":
        return _material_boxes(image_px=16, env_px=16)
    return (jpresets.cornell_box(8, 8, 1, force_bvh=True),
            tpresets.cornell_box(8, 8, 1, force_bvh=True))


def _ulps(a, b):
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("kind", ["brute", "bvh"])
def test_intersect_and_occluded_match_reference(kind):
    """Rays from inside the box in every direction (some of them dead
    lanes, whose window the port shuts) against the material box (21
    primitives, brute force: K1 / K2) and the BVH Cornell box (K3)."""
    from gdpt_tpu.core.dtypes import BIG
    from gdpt_tpu.ops import intersect as jisect
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.ops import intersect as tisect

    js, ts = _cast_scenes(kind)
    assert ts.static.use_brute_force == (kind == "brute")
    rng = np.random.default_rng(6)
    org = _f32(rng.uniform(20, 530, (N, 3)))
    d = _unit(rng)
    live = rng.random(N) < 0.9
    casts = tisect.Casts(path_soa.scene_soa_from_aos(ts).geom)
    tv = tisect.intersect(ts.device, ts.static, casts, _t(org), _t(d), 0.0, 1e30, _t(live))
    assert int(casts.rays) == live.sum()
    jv = _vmap(lambda o, x: jisect.intersect(js.device, js.static, o, x, 0.0, BIG), org, d)
    jv = type(tv)(*jv)
    valid = tv.valid.numpy()
    assert not valid[~live].any() and valid[live].mean() > 0.7  # the front is open
    assert (valid[live] == jv.valid[live]).mean() >= SHARE
    both = live & valid & jv.valid
    assert (_ulps(tv.position.numpy()[both], jv.position[both]) <= 64).mean() >= SHARE
    t_port = np.linalg.norm(tv.position.numpy() - org, axis=1)
    t_ref = np.linalg.norm(jv.position - org, axis=1)
    close(t_port, t_ref, both)
    same = both & (tv.prim_id.numpy() == jv.prim_id)
    assert same.sum() >= SHARE * both.sum() - 5  # ties on shared edges only
    for f in ("geom_normal", "frame", "uv", "shape_id", "material_id",
              "interior_medium_id", "exterior_medium_id", "mean_curvature"):
        close(getattr(tv, f).numpy(), getattr(jv, f), same, atol=1e-5)

    # Shadow rays toward points along each ray: occluded where a surface
    # lies before the point.
    tfar = _f32(rng.uniform(1.0, 600.0, N))
    occ = tisect.occluded(ts.static, casts, _t(org), _t(d), 1e-3, _t(tfar), _t(live)).numpy()
    jocc = _vmap(lambda o, x, f: jisect.occluded(js.device, js.static, o, x, 1e-3, f),
                 org, d, tfar)
    assert not occ[~live].any()
    assert (occ[live] == jocc[live]).mean() >= SHARE and 0.1 < occ[live].mean() < 0.95
    assert int(casts.rays) == 2 * live.sum()


def test_cast_t_within_ulps():
    """The hit distance itself (cast's t) against the reference's, on
    the brute-force box: within 4 ulp on 99.9% of lanes hit by both."""
    import jax

    from gdpt_tpu.accel import traverse as jtr
    from gdpt_tpu.core.dtypes import BIG
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.ops import intersect as tisect

    js, ts = _cast_scenes("brute")
    rng = np.random.default_rng(7)
    org = _f32(rng.uniform(20, 530, (N, 3)))
    d = _unit(rng)
    casts = tisect.Casts(path_soa.scene_soa_from_aos(ts).geom)
    hit = tisect.cast(ts.static, casts, _t(org), _t(d), 0.0, 1e30)
    jh = jax.vmap(lambda o, x: jtr.intersect_brute(js.device.geom, o, x, 0.0, BIG))(org, d)
    both = (hit.prim_id.numpy() >= 0) & (np.asarray(jh.prim_id) >= 0)
    assert both.mean() > 0.7
    assert (_ulps(hit.t.numpy()[both], np.asarray(jh.t)[both]) <= 4).mean() >= SHARE
    miss = hit.prim_id.numpy() < 0
    assert (hit.t.numpy()[miss] == np.float32(1e30)).all()
