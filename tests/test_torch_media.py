"""The port's participating-media ops (gdpt_tpu_torch/ops/media_soa.py)
against gdpt_tpu.ops.media_soa, function by function, on 4,096 lanes
made with numpy from a seed.

Four media in one table, each lane in one of them or in none (-1): a
homogeneous medium with Henyey-Greenstein g = 0.8; a heterogeneous one
on a varying, chromatic, non-cubic grid with a constant albedo and an
isotropic phase; one whose albedo is a grid too (another resolution),
with g = -0.5; a homogeneous one with g = 5e-4, which takes the
|g| < 1e-3 uniform-sphere fallback. Points inside the grid's bbox,
outside it and on its faces; rays that hit it, that miss it and that run
parallel to an axis (the 1e-20 guard).

Tolerance: rtol 1e-5 / atol 1e-6 for every value (f32 transcendentals
and the reference's powf differ from torch's by an ulp), and every
output finite. The slab test and the medium transition are equal.
"""

import types

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.core.soa import V3 as TV3
from gdpt_tpu_torch.ops import media_soa as tmed

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

N = 4096
RTOL, ATOL = 1e-5, 1e-6
P_MIN, P_MAX = np.array([-1.0, -2.0, -0.5]), np.array([2.0, 1.0, 1.5])


def _grid(shape, seed, lo, hi):
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random(shape + (3,)) ** 3).astype(np.float32)


def _host_media(M):
    density = M.GridVolume(_grid((4, 5, 6), 1, 0.1, 3.0), p_min=P_MIN, p_max=P_MAX)
    return [
        M.HomogeneousMedium(sigma_a=np.array([0.1, 0.2, 0.05]),
                            sigma_s=np.array([0.7, 0.5, 0.9]), phase=M.HenyeyGreenstein(0.8)),
        M.HeterogeneousMedium(albedo=np.array([0.8, 0.6, 0.9]), density=density,
                              phase=M.IsotropicPhase()),
        M.HeterogeneousMedium(
            albedo=M.GridVolume(_grid((3, 7, 2), 2, 0.2, 0.95), p_min=P_MIN, p_max=P_MAX),
            density=density, phase=M.HenyeyGreenstein(-0.5)),
        M.HomogeneousMedium(sigma_a=np.array([0.3, 0.3, 0.3]),
                            sigma_s=np.array([0.2, 0.4, 0.6]), phase=M.HenyeyGreenstein(5e-4)),
    ]


def _tables(which):
    """(media arrays as the package's SoA tables, static facts) of the four
    media, built with the package's own model and build modules."""
    if which == "ref":
        from gdpt_tpu.ops import media_soa as med
        from gdpt_tpu.scene import build, model as M
    else:
        from gdpt_tpu_torch.scene import build, model as M
        med = tmed
    arrays, kinds, hetero, albedo_grid = build._build_media(_host_media(M))
    static = types.SimpleNamespace(
        media_phase_kinds=kinds, media_is_hetero=hetero, media_albedo_is_grid=albedo_grid,
        media_grid_res=tuple(
            tuple((int(v.grid.shape[2]), int(v.grid.shape[1]), int(v.grid.shape[0]))
                  for v in (m.density, m.albedo)) for m in arrays))
    return med.media_soa(arrays), static


def _lanes():
    """Points (inside, outside, on a face), rays (some parallel to an
    axis), unit directions, uniforms and medium ids, as numpy arrays."""
    rng = np.random.default_rng(7)
    third = N // 3
    p = rng.uniform(P_MIN, P_MAX, (N, 3))
    p[third:2 * third] = rng.uniform(P_MIN - 3, P_MAX + 3, (third, 3))
    face = rng.integers(0, 3, N - 2 * third)
    side = rng.integers(0, 2, N - 2 * third)
    p[2 * third:][np.arange(N - 2 * third), face] = np.where(side, P_MAX[face], P_MIN[face])
    d = rng.normal(size=(N, 3))
    flat = rng.random(N) < 0.25
    d[flat, rng.integers(0, 3, int(flat.sum()))] = 0.0
    d[~flat & (rng.random(N) < 0.05), :2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dout = rng.normal(size=(N, 3))
    dout /= np.linalg.norm(dout, axis=1, keepdims=True)
    return dict(p=p.astype(np.float32), d=d.astype(np.float32), dout=dout.astype(np.float32),
                u=rng.random((2, N)).astype(np.float32),
                tfar=rng.uniform(0.5, 6.0, N).astype(np.float32),
                medium=rng.integers(-1, 4, N).astype(np.int32))


LANES = _lanes()


def _jv3(a):
    from gdpt_tpu.core.soa import V3

    import jax.numpy as jnp
    return V3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv3(a):
    return TV3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _close(got, ref):
    got = np.stack([np.asarray(c) for c in got]) if isinstance(got, tuple) else np.asarray(got)
    ref = np.stack([np.asarray(c) for c in ref]) if isinstance(ref, tuple) else np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _both(fn_ref, fn_port):
    """Run a function of each package on the same lanes."""
    import jax.numpy as jnp

    jm, js = _tables("ref")
    tm, ts = _tables("port")
    L = LANES
    ref = fn_ref(jm, js, dict(p=_jv3(L["p"]), d=_jv3(L["d"]), dout=_jv3(L["dout"]),
                              u=[jnp.asarray(x) for x in L["u"]], tfar=jnp.asarray(L["tfar"]),
                              medium=jnp.asarray(L["medium"])))
    got = fn_port(tm, ts, dict(p=_tv3(L["p"]), d=_tv3(L["d"]), dout=_tv3(L["dout"]),
                               u=[torch.from_numpy(x) for x in L["u"]],
                               tfar=torch.from_numpy(L["tfar"]),
                               medium=torch.from_numpy(L["medium"])))
    return got, ref


def test_media_tables():
    """The grid is flattened into (3, X*Y*Z) component rows, x fastest."""
    (jm, _), (tm, _) = _tables("ref"), _tables("port")
    for j, t in zip(jm, tm):
        for jv, tv in ((j.albedo, t.albedo), (j.density, t.density)):
            np.testing.assert_array_equal(np.stack([np.asarray(c) for c in jv.flat]),
                                          tv.flat.numpy())
            for f in ("value", "p_min", "p_max", "max_data", "scale"):
                np.testing.assert_array_equal(np.asarray(getattr(jv, f)), getattr(tv, f).numpy())
        np.testing.assert_array_equal(np.asarray(j.phase_g), t.phase_g.numpy())


@pytest.mark.parametrize("which", ["density", "albedo grid", "albedo const"])
def test_volume_lookup(which):
    from gdpt_tpu.ops import media_soa as jmed

    m, attr, grid = {"density": (1, "density", True), "albedo grid": (2, "albedo", True),
                     "albedo const": (1, "albedo", False)}[which]

    def run(med):
        def fn(media, static, L):
            res = static.media_grid_res[m][0 if attr == "density" else 1]
            return med.volume_lookup_soa(getattr(media[m], attr), grid, L["p"], res)
        return fn

    got, ref = _both(run(jmed), run(tmed))
    _close(got, ref)
    if grid:
        inside = np.asarray(ref[0]) != 0
        assert 0.3 < inside.mean() < 0.9  # inside and on faces; zero outside


@pytest.mark.parametrize("tfar", ["big", "per ray"])
def test_ray_hits_bbox(tfar):
    from gdpt_tpu.ops import media_soa as jmed

    def run(med):
        def fn(media, static, L):
            return med.volume_ray_hits_bbox_soa(media[1].density, L["p"], L["d"],
                                                L["tfar"] if tfar == "per ray" else 1e30)
        return fn

    got, ref = _both(run(jmed), run(tmed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.2 < np.asarray(ref).mean() < 0.95


@pytest.mark.parametrize("fn", ["get_majorant_soa", "get_sigma_a_soa", "get_sigma_s_soa"])
def test_coefficients(fn):
    from gdpt_tpu.ops import media_soa as jmed

    def run(med):
        def call(media, static, L):
            args = (L["p"], L["d"]) if fn == "get_majorant_soa" else (L["p"],)
            return getattr(med, fn)(media, static, L["medium"], *args)
        return call

    got, ref = _both(run(jmed), run(tmed))
    _close(got, ref)


@pytest.mark.parametrize("fn", ["phase_eval_soa", "phase_pdf_soa"])
def test_phase_value(fn):
    from gdpt_tpu.ops import media_soa as jmed

    def run(med):
        def call(media, static, L):
            return getattr(med, fn)(media, static, L["medium"], L["d"], L["dout"])
        return call

    got, ref = _both(run(jmed), run(tmed))
    _close(got, ref)


def test_phase_sample():
    from gdpt_tpu.ops import media_soa as jmed

    def run(med):
        def call(media, static, L):
            return med.phase_sample_soa(media, static, L["medium"], L["d"], *L["u"])
        return call

    got, ref = _both(run(jmed), run(tmed))
    _close(got, ref)
    norm = np.sqrt(sum(np.asarray(c, np.float64) ** 2 for c in got))
    np.testing.assert_allclose(norm, 1.0, atol=1e-3)


@pytest.mark.parametrize("g", [0.0, 0.8, -0.5, 5e-4])
def test_hg_value(g):
    import jax.numpy as jnp

    from gdpt_tpu.ops import media_soa as jmed

    cos_t = np.linspace(-1.0, 1.0, N, dtype=np.float32)
    ref = jmed._hg_value(jnp.float32(g), jnp.asarray(cos_t))
    got = tmed._hg_value(torch.tensor(g, dtype=torch.float32), torch.from_numpy(cos_t))
    _close(got, ref)


def test_update_medium():
    import jax.numpy as jnp

    from gdpt_tpu.ops import media_soa as jmed

    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 3, (3, N)).astype(np.int32)
    L = LANES
    ref = jmed.update_medium_soa(*(jnp.asarray(a) for a in ids[:2]), _jv3(L["d"]),
                                 _jv3(L["dout"]), jnp.asarray(ids[2]))
    got = tmed.update_medium_soa(*(torch.from_numpy(a) for a in ids[:2]), _tv3(L["d"]),
                                 _tv3(L["dout"]), torch.from_numpy(ids[2]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() != ids[2]).mean() > 0.3


def test_pow15_follows_xla():
    """XLA's CPU pow(x, 1.5) in _hg_value is a near correctly rounded
    powf: the f64 power rounded to f32 (the port's _pow15) matches it on
    at least 99.9% of 1,000,000 lanes in (1e-8, 4), torch's f32 pow on
    fewer."""
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(0).uniform(1e-8, 4, 1_000_000).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.power(a, 1.5))(jnp.asarray(x)))
    t = torch.from_numpy(x)
    f64 = float((tmed._pow15(t).numpy() == ref).mean())
    f32 = float((torch.pow(t, 1.5).numpy() == ref).mean())
    print(f"pow(x, 1.5) equal to XLA's: f64 rounded {f64:.5f}, torch f32 {f32:.5f}")
    assert f64 >= 0.999 and f64 > f32
