"""The port's SoA material stack (ops/materials_soa.py) against gdpt_tpu's,
on the CPU: every material kind's eval, pdf and sample, the image
texture slots of gather_params_soa, and the port's own sample/pdf
consistency.

Each of the nine kinds gets 4,096 lanes drawn with numpy from a seed:
din and dout on both sides of the geometric normal, a random shading
frame, u0, u1 and w in [0, 1), parameters over the model's ranges.
Tolerances: every output is finite; eval and pdf agree within rtol 1e-4
/ atol 1e-6 on at least 99.9% of lanes; sample's valid flag agrees on at
least 99.9% of lanes, and dir_out, eta and roughness within atol 1e-4 on
at least 99.9% of the lanes where both are valid. Shares, not every
lane, because a lobe choice that compares a random number with a float
weight (Disney BSDF's w < c1/c2/c3, the rough dielectric's Fresnel
choice) flips on one ulp between XLA and torch, and a flipped lane
differs completely.

The consistency check mirrors tests/test_materials.py on the SoA
functions at 50,000 samples (a quarter of its 200,000): the histogram of
sampled directions over an 8 x 16 spherical grid matches the integral of
the pdf over each bin, and the pdf integrates to the share of samples it
covers. With a quarter of the samples, per-bin agreement is taken over
the bins of at least 4 times the reference test's mass threshold (8e-3
in place of 2e-3), so each compared bin holds as many samples.
"""

import math

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.ops import materials_soa as tm
from gdpt_tpu_torch.scene import model as M

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

N = 4096
ALL_KINDS = [
    M.MAT_LAMBERTIAN, M.MAT_ROUGH_PLASTIC, M.MAT_ROUGH_DIELECTRIC,
    M.MAT_DISNEY_DIFFUSE, M.MAT_DISNEY_METAL, M.MAT_DISNEY_GLASS,
    M.MAT_DISNEY_CLEARCOAT, M.MAT_DISNEY_SHEEN, M.MAT_DISNEY_BSDF,
]
SHARE = 0.999


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _lanes(kind):
    """numpy inputs of one kind's lanes: params (dict of (N,) or (N, 3)),
    din, dout, gn, shading frame (t, b, n), u0, u1, w."""
    rng = np.random.default_rng(100 + kind)
    gn = _unit(rng, N)
    sn = gn + 0.4 * rng.normal(size=(N, 3))
    sn /= np.linalg.norm(sn, axis=1, keepdims=True)
    # The vertex's geometric normal is flipped toward the shading normal.
    gn = np.where(((gn * sn).sum(1) < 0)[:, None], -gn, gn)
    f = soa.coordinate_system(V3(*torch.from_numpy(sn.T.astype(np.float32).copy())))
    frame = np.stack([np.stack([c.numpy() for c in v], 1) for v in f])
    din, dout = _unit(rng, N), _unit(rng, N)
    u0, u1, w = rng.random((3, N))
    params = dict(kind=np.full(N, kind, np.int32), eta=rng.uniform(1.05, 2.2, N))
    for name in ("refl", "spec_refl", "spec_trans"):
        params[name] = rng.random((N, 3))
    for name in tm.MatParamsSoA._fields[5:]:
        params[name] = rng.random(N)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    params = {k: (v if v.dtype == np.int32 else f32(v)) for k, v in params.items()}
    return params, f32(din), f32(dout), f32(gn), f32(frame), f32(u0), f32(u1), f32(w)


def _port_inputs(lanes):
    params, din, dout, gn, frame, u0, u1, w = lanes
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    v3 = lambda a: V3(*(t(a[:, i]) for i in range(3)))  # noqa: E731
    p = tm.MatParamsSoA(**{k: (v3(v) if v.ndim == 2 else t(v)) for k, v in params.items()})
    return (p, v3(din), v3(dout), v3(gn), soa.Frame(*(v3(frame[i]) for i in range(3))),
            t(u0), t(u1), t(w))


def _reference_inputs(lanes):
    import jax.numpy as jnp
    from gdpt_tpu.core import soa as jsoa
    from gdpt_tpu.ops import materials_soa as jm

    params, din, dout, gn, frame, u0, u1, w = lanes
    v3 = lambda a: jsoa.V3(*(jnp.asarray(a[:, i]) for i in range(3)))  # noqa: E731
    p = jm.MatParamsSoA(**{k: (v3(v) if v.ndim == 2 else jnp.asarray(v))
                           for k, v in params.items()})
    return (p, v3(din), v3(dout), v3(gn), jsoa.Frame(*(v3(frame[i]) for i in range(3))),
            jnp.asarray(u0), jnp.asarray(u1), jnp.asarray(w))


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x], -1)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _share_close(got, ref, rtol, atol, mask=None):
    ok = np.isclose(got, ref, rtol=rtol, atol=atol)
    ok = ok.reshape(ok.shape[0], -1).all(axis=1)
    return ok[mask].mean() if mask is not None else ok.mean()


_CACHE = {}


def _both(kind):
    """{(package, function): outputs as numpy} for one kind's lanes."""
    if kind not in _CACHE:
        from gdpt_tpu.ops import materials_soa as jm

        lanes = _lanes(kind)
        out = {}
        for pkg, mod, inputs in (("port", tm, _port_inputs(lanes)),
                                 ("ref", jm, _reference_inputs(lanes))):
            p, din, dout, gn, frame, u0, u1, w = inputs
            used = (kind,)
            out[pkg, "eval"] = _np(tuple(mod.eval_bsdf_soa(p, din, dout, gn, frame, used)))
            out[pkg, "pdf"] = _np(mod.pdf_bsdf_soa(p, din, dout, gn, frame, used))
            s = mod.sample_bsdf_soa(p, din, gn, frame, u0, u1, w, used)
            out[pkg, "sample"] = (_np(tuple(s.dir_out)), _np(s.eta), _np(s.roughness),
                                  _np(s.valid))
        _CACHE[kind] = out
    return _CACHE[kind]


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_eval_and_pdf_match_reference(kind):
    out = _both(kind)
    for fn in ("eval", "pdf"):
        got, ref = out["port", fn], out["ref", fn]
        assert got.shape == ref.shape and np.isfinite(got).all(), fn
        assert (got >= 0).all(), fn
        assert _share_close(got, ref, 1e-4, 1e-6) >= SHARE, fn
    assert out["port", "pdf"].max() > 0


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_sample_matches_reference(kind):
    out = _both(kind)
    (gd, ge, gr, gv), (rd, re, rr, rv) = out["port", "sample"], out["ref", "sample"]
    for a in (gd, ge, gr, gv):
        assert np.isfinite(a).all()
    assert (gv == rv).mean() >= SHARE and gv.mean() > 0.2
    both = (gv > 0) & (rv > 0)
    for got, ref in ((gd, rd), (ge, re), (gr, rr)):
        assert _share_close(got, ref, 0.0, 1e-4, both) >= SHARE
    np.testing.assert_allclose(np.linalg.norm(gd[gv > 0], axis=1), 1.0, atol=1e-3)


def test_every_lobe_of_the_disney_bsdf_is_taken():
    """Its sampled lanes reach the diffuse, metal, clearcoat and glass
    lobes (told apart by their roughness and eta outputs)."""
    p, din, dout, gn, frame, u0, u1, w = _port_inputs(_lanes(M.MAT_DISNEY_BSDF))
    s = tm.sample_bsdf_soa(p, din, gn, frame, u0, u1, w, (M.MAT_DISNEY_BSDF,))
    rough = tm._clamp_rough(p.roughness)
    above = (soa.dot(gn, din) > 0) & (s.valid > 0)
    cc = (s.roughness == tm._clearcoat_alpha(p.clearcoat_gloss)) & (s.eta == 0)
    glass = s.eta != 0
    diffuse_or_metal = (s.roughness == rough) & (s.eta == 0)
    for lobe in (cc, glass, diffuse_or_metal):
        assert int((lobe & above).sum()) > 50


# ---------------------------------------------------------------------------
# Texture slots of gather_params_soa
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("footprint", [False, True])
def test_gather_params_image_slots_match_reference(footprint):
    """Spectrum (back wall colour) and float (floor roughness) image
    slots, level 0 without a footprint and mip-filtered with one, on every
    material of the material box, built by each package."""
    import jax.numpy as jnp
    from gdpt_tpu.core import transform as jxf
    from gdpt_tpu.integrators import path_soa as jpath
    from gdpt_tpu.ops import materials_soa as jm
    from gdpt_tpu.scene import build as jbuild
    from gdpt_tpu.scene import model as jmodel
    from gdpt_tpu_torch.integrators import path_soa as tpath
    from gdpt_tpu_torch.scene import presets as tpresets

    js = tpresets.build_material_box(jmodel, jbuild, jxf, 8, 8, 1, image_px=32, seed=2)
    ts = tpresets.material_box(8, 8, 1, image_px=32, seed=2)
    st = ts.static
    assert st.spec_image_slots[0] and st.float_tex_slots[0] == 2
    jt, tt = jpath.scene_soa_from_aos(js).mat_tables, tpath.scene_soa_from_aos(ts).mat_tables
    rng = np.random.default_rng(9)
    n_mat = int(tt.kind.shape[0])
    mid = rng.integers(-1, n_mat, N).astype(np.int32)
    u, v = rng.uniform(-0.2, 1.2, (2, N)).astype(np.float32)
    fp = (rng.uniform(0.0, 0.2, N) ** 2).astype(np.float32) if footprint else None
    kinds = st.used_material_kinds
    ref = jm.gather_params_soa(jt, kinds, jnp.asarray(mid), jnp.asarray(u), jnp.asarray(v),
                               st.spec_image_slots, float_tex_slots=st.float_tex_slots,
                               fp=None if fp is None else jnp.asarray(fp))
    got = tm.gather_params_soa(tt, kinds, *(torch.from_numpy(a) for a in (mid, u, v)),
                               st.spec_image_slots, float_tex_slots=st.float_tex_slots,
                               fp=None if fp is None else torch.from_numpy(fp))
    for name in tm.MatParamsSoA._fields:
        a, b = getattr(got, name), getattr(ref, name)
        a, b = (_np(tuple(a)), _np(tuple(b))) if isinstance(a, tuple) else (_np(a), _np(b))
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    wall = mid == 0  # the image-textured wall: its lookups vary over uv
    assert np.ptp(got.refl.x.numpy()[wall]) > 0.05
    assert np.ptp(got.roughness.numpy()[mid == 5]) > 0.05


# ---------------------------------------------------------------------------
# Sample / pdf consistency (mirrors tests/test_materials.py:75-150)
# ---------------------------------------------------------------------------

N_SAMPLES = 50_000


def _fixed_params(kind, n):
    f = lambda x: torch.full((n,), x, dtype=torch.float32)  # noqa: E731
    v3 = lambda a, b, c: V3(f(a), f(b), f(c))  # noqa: E731
    return tm.MatParamsSoA(
        kind=torch.full((n,), kind, dtype=torch.int32), eta=f(1.5),
        refl=v3(0.6, 0.4, 0.3), spec_refl=v3(0.9, 0.9, 0.9), spec_trans=v3(0.8, 0.8, 0.8),
        roughness=f(0.3), anisotropic=f(0.2), subsurface=f(0.3), metallic=f(0.4),
        specular=f(0.5), specular_tint=f(0.3), sheen=f(0.5), sheen_tint=f(0.5),
        clearcoat=f(0.6), clearcoat_gloss=f(0.7), specular_transmission=f(0.4))


def _flat_vertex(n):
    z, o = torch.zeros(n), torch.ones(n)
    din = np.array([0.4, -0.25, 0.88])
    din = (din / np.linalg.norm(din)).astype(np.float32)
    return (V3(*(torch.full((n,), float(c)) for c in din)), V3(z, z, o),
            soa.Frame(V3(o, z, z), V3(z, o, z), V3(z, z, o)))


def _bin_id(d, n_theta=8, n_phi=16):
    ct = np.clip((d[:, 2] + 1.0) * 0.5, 0.0, 1.0 - 1e-7)
    phi = np.arctan2(d[:, 1], d[:, 0])
    phi_bin = np.clip(((phi / (2 * np.pi) + 0.5) * n_phi).astype(np.int64), 0, n_phi - 1)
    return (ct * n_theta).astype(np.int64) * n_phi + phi_bin


def _pdf_at(kind, dirs):
    n = dirs.shape[0]
    din, gn, frame = _flat_vertex(n)
    dd = V3(*(torch.from_numpy(np.ascontiguousarray(dirs[:, i], np.float32)) for i in range(3)))
    return tm.pdf_bsdf_soa(_fixed_params(kind, n), din, dd, gn, frame, (kind,)).numpy()


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_sample_pdf_consistency(kind):
    rng = np.random.default_rng(kind)
    u0, u1, w = (torch.from_numpy(a) for a in rng.random((3, N_SAMPLES)).astype(np.float32))
    din, gn, frame = _flat_vertex(N_SAMPLES)
    s = tm.sample_bsdf_soa(_fixed_params(kind, N_SAMPLES), din, gn, frame, u0, u1, w, (kind,))
    d = _np(tuple(s.dir_out)).astype(np.float64)
    valid = s.valid.numpy() > 0
    assert valid.mean() > 0.99
    n_total = int(valid.sum())
    d = d[valid]
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-3)
    # Directions the pdf gives no mass (clearcoat half-vector reflections
    # below the horizon) are left out of both sides, as in the reference.
    kept = _pdf_at(kind, d) > 0
    d = d[kept]
    n_bins = 8 * 16
    sampled = np.bincount(_bin_id(d), minlength=n_bins) / n_total
    nt = nphi = 512
    ct = (np.arange(nt) + 0.5) / nt * 2.0 - 1.0
    phi = (np.arange(nphi) + 0.5) / nphi * 2.0 * np.pi
    ctg, phg = np.meshgrid(ct, phi, indexing="ij")
    st_ = np.sqrt(1.0 - ctg ** 2)
    dirs = np.stack([st_ * np.cos(phg), st_ * np.sin(phg), ctg], -1).reshape(-1, 3)
    pdfs = _pdf_at(kind, dirs).astype(np.float64)
    assert np.isfinite(pdfs).all()
    integral = np.zeros(n_bins)
    np.add.at(integral, _bin_id(dirs), pdfs * (2.0 / nt) * (2.0 * math.pi / nphi))
    total = integral.sum()
    assert abs(total - kept.mean()) < 0.05, f"pdf integral {total} vs kept {kept.mean()}"
    assert total > 0.8
    mask = integral > 8e-3
    assert mask.any()
    rel = np.abs(sampled[mask] - integral[mask]) / integral[mask]
    assert np.quantile(rel, 0.9) < 0.15, f"kind {kind}: q90 {np.quantile(rel, 0.9)}"
