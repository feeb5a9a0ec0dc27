"""The port's SoA texture and envmap lookups (ops/textures_soa.py)
against gdpt_tpu's, on the CPU.

Inputs are drawn with numpy from a seed; texture pools and envmap tables
are built by each package's own host code from the same images.
Tolerances: the image lookups and the bisection are the same gathers and
the same f32 multiply-adds in the same order, so indices are held equal
and values to rtol 1e-6 / atol 1e-7. The envmap's direction transforms
go through arctan2 / arccos / sin / cos, whose f32 results may differ by
an ulp between XLA and torch: uv and directions within atol 1e-5; a
piecewise-constant pdf or a texel index can change where an ulp crosses
a texel edge, so those are held on at least 99.9% of lanes, the rest
within rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import path_soa as tpath
from gdpt_tpu_torch.ops import textures_soa as tt
from gdpt_tpu_torch.scene import presets as tpresets
from gdpt_tpu_torch.scene import textures as ttex

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

N = 4096


def _images(channels, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(16, 16), (8, 20), (1, 5), (33, 7)]
    if channels == 3:
        return [rng.random((h, w, 3)).astype(np.float32) for h, w in shapes]
    return [rng.random((h, w)).astype(np.float32) for h, w in shapes]


def _pools(channels):
    """(reference pool view, port pool view) of the same images."""
    from gdpt_tpu.ops import textures_soa as jt
    from gdpt_tpu.scene import textures as jtex

    imgs = _images(channels)
    jp = jtex.build_texture_pool(imgs, channels)
    tp = ttex.build_texture_pool(imgs, channels)
    if channels == 3:
        return jt.pool3_soa(jp), tt.pool3_soa(tp)
    return jt.pool1_soa(jp), tt.pool1_soa(tp)


def _lanes(seed=1):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 4, N).astype(np.int32)
    u = rng.uniform(-0.5, 1.5, N).astype(np.float32)
    v = rng.uniform(-0.5, 1.5, N).astype(np.float32)
    level = rng.uniform(-2.0, 9.0, N).astype(np.float32)
    return img, u, v, level


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x], -1)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _j(*arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("fn", ["trilinear", "trilinear_f", "bilinear_level0",
                                "bilinear_level0_f"])
def test_image_lookups_match_reference(fn):
    from gdpt_tpu.ops import textures_soa as jt

    jp, tp = _pools(1 if fn.endswith("_f") else 3)
    img, u, v, level = _lanes()
    args = (img, u, v, level) if fn.startswith("trilinear") else (img, u, v)
    ref = _np(getattr(jt, fn)(jp, *_j(*args)))
    got = _np(getattr(tt, fn)(tp, *_t(*args)))
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_footprint_level_matches_reference():
    from gdpt_tpu.ops import textures_soa as jt

    jp, tp = _pools(3)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 4, N).astype(np.int32)
    us, vs = rng.uniform(0.5, 4.0, (2, N)).astype(np.float32)
    fp = np.concatenate([np.zeros(16), rng.uniform(0.0, 0.5, N - 16)]).astype(np.float32)
    ref = _np(jt.footprint_level(jp, *_j(img, us, vs, fp)))
    got = _np(tt.footprint_level(tp, *_t(img, us, vs, fp)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_searchsorted_rows_on_flat_runs():
    """Rows of a 2D table with zero-weight runs (black texels) have flat
    cdf runs; u drawn at random and set exactly onto cdf values. The
    bisection returns searchsorted(row, u, 'right') - 1, the reference's
    index on every lane."""
    from gdpt_tpu.ops import textures_soa as jt
    from gdpt_tpu_torch.core import distributions as tdist

    rng = np.random.default_rng(3)
    w, h = 37, 9
    f = rng.random((h, w))
    f[:, 5:12] = 0.0
    f[2, :] = 0.0          # an all-black row: the uniform fallback
    f[4, 20:] = 0.0
    rows = tdist.make_table_dist_2d(f.ravel(), w, h).cdf_rows.numpy()
    y = rng.integers(0, h, N).astype(np.int32)
    u = rng.random(N).astype(np.float32)
    on = rng.random(N) < 0.5
    u[on] = rows[y[on], rng.integers(0, w + 1, int(on.sum()))]
    flat = rows.ravel()
    ref = _np(jt.searchsorted_rows(*_j(flat), w + 1, *_j(y, u), w))
    got = _np(tt.searchsorted_rows(torch.from_numpy(flat), w + 1, *_t(y, u), w))
    np.testing.assert_array_equal(got, ref)
    want = np.array([np.searchsorted(rows[yy], uu, side="right") - 1 for yy, uu in zip(y, u)])
    np.testing.assert_array_equal(got, np.clip(want, 0, w - 1))


def _envs(kind):
    """(reference EnvmapSoA, pool, port EnvmapSoA, pool) of a constant
    (furnace) or image (material box) envmap, each built by its package."""
    from gdpt_tpu.core import transform as jxf
    from gdpt_tpu.integrators import path_soa as jpath
    from gdpt_tpu.scene import build as jbuild
    from gdpt_tpu.scene import model as jmodel
    from gdpt_tpu.scene import presets as jpresets

    if kind == "constant":
        js, ts = jpresets.furnace_sphere(0.6, 1.3), tpresets.furnace_sphere(0.6, 1.3)
    else:
        js = tpresets.build_material_box(jmodel, jbuild, jxf, 8, 8, 1, env_px=16, seed=4)
        ts = tpresets.material_box(8, 8, 1, env_px=16, seed=4)
    jsc, tsc = jpath.scene_soa_from_aos(js), tpath.scene_soa_from_aos(ts)
    return (jpath._env_view(js.static, jsc), jsc.mat_tables.pool3,
            tpath._env_view(ts.static, tsc), tsc.mat_tables.pool3)


def _dirs(seed):
    d = np.random.default_rng(seed).normal(size=(3, N))
    d /= np.linalg.norm(d, axis=0)
    return d.astype(np.float32)


def _share_close(got, ref, rtol, atol):
    ok = np.isclose(got, ref, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


@pytest.mark.parametrize("kind", ["constant", "image"])
def test_envmap_lookups_match_reference(kind):
    from gdpt_tpu.core.soa import V3 as JV3
    from gdpt_tpu.ops import textures_soa as jt

    jenv, jpool, tenv, tpool = _envs(kind)
    assert (tenv.tex_kind, tenv.width, tenv.height) == (jenv.tex_kind, jenv.width, jenv.height)
    d = _dirs(5)
    jd, td = JV3(*_j(*d)), V3(*_t(*d))
    ref_uv = _np(jt.envmap_uv_from_dir(jenv, jd))
    got_uv = _np(tt.envmap_uv_from_dir(tenv, td))
    np.testing.assert_allclose(got_uv, ref_uv, rtol=0, atol=1e-5)
    ref_e = _np(jt.envmap_emission_soa(jenv, jpool, jd))
    got_e = _np(tt.envmap_emission_soa(tenv, tpool, td))
    assert np.isfinite(got_e).all() and got_e.max() > 0
    np.testing.assert_allclose(got_e, ref_e, rtol=1e-4, atol=1e-5)
    ref_rp = jt.envmap_emission_pdf_soa(jenv, jpool, jd)
    got_rp = tt.envmap_emission_pdf_soa(tenv, tpool, td)
    np.testing.assert_allclose(_np(got_rp[0]), _np(ref_rp[0]), rtol=1e-4, atol=1e-5)
    ref_pdf, got_pdf = _np(jt.envmap_pdf_dir(jenv, jd)), _np(tt.envmap_pdf_dir(tenv, td))
    assert np.isfinite(got_pdf).all() and (got_pdf >= 0).all()
    np.testing.assert_array_equal(_np(got_rp[1]), got_pdf)
    assert _share_close(got_pdf, ref_pdf, 1e-4, 0.0) >= 0.999


@pytest.mark.parametrize("kind", ["constant", "image"])
def test_envmap_sample_matches_reference(kind):
    from gdpt_tpu.ops import textures_soa as jt

    jenv, _, tenv, _ = _envs(kind)
    rng = np.random.default_rng(6)
    u0, u1 = rng.random((2, N)).astype(np.float32)
    jd, jpdf = jt.envmap_sample_dir(jenv, *_j(u0, u1))
    td, tpdf = tt.envmap_sample_dir(tenv, *_t(u0, u1))
    got_d, ref_d = _np(tuple(td)), _np(tuple(jd))
    assert np.isfinite(got_d).all()
    np.testing.assert_allclose(got_d, ref_d, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tpdf), _np(jpdf), rtol=1e-4, atol=0)


@pytest.mark.parametrize("kind", ["constant", "image"])
def test_envmap_sample_pdf_is_pdf_dir(kind):
    """The pdf envmap_sample_dir returns is envmap_pdf_dir's at the
    sampled direction (the same texel, up to an ulp at its edge). Both
    divide by the sine of the elevation, the sampler's sin(elevation)
    and the lookup's sqrt(1 - y^2); within 0.05 of a pole the latter
    cancels, so the lanes there are left out."""
    _, _, tenv, _ = _envs(kind)
    rng = np.random.default_rng(7)
    u0, u1 = _t(*rng.random((2, N)).astype(np.float32))
    d, pdf = tt.envmap_sample_dir(tenv, u0, u1)
    again = tt.envmap_pdf_dir(tenv, d)
    assert bool((pdf > 0).all()) and bool(torch.isfinite(again).all())
    away = tt.envmap_uv_from_dir(tenv, d)[2].numpy() > 0.05
    assert away.mean() > 0.95
    assert _share_close(again.numpy()[away], pdf.numpy()[away], 1e-3, 0.0) >= 0.999
