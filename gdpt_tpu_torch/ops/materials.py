"""The per-ray material system: 9 BSDFs with eval / pdf / sample.

Counterpart of gdpt_tpu/ops/materials.py (reference: src/material.h +
src/materials/*.inl), lane-batched: each hit gathers a unified parameter
row (textures pre-evaluated) and every kind present in the scene is
evaluated branch-free on all lanes, selected by the lane's material
kind. This module is the per-ray integrators' oracle, held to the
reference's per-ray functions on seeded lanes; the SoA renders use
ops/materials_soa.py.

Conventions (the reference's): dir_in points from the surface toward the
viewer, dir_out toward the light, both outward; eval returns BSDF *
|cos(out)|; pdf is in solid angle measure; sample returns (dir_out, eta,
roughness, valid), eta = 0 for reflection. Vectors are (N, 3), per-lane
scalars (N,), frames (N, 3, 3).
"""

import math
from typing import NamedTuple

import torch

from gdpt_tpu_torch.core import math as gm
from gdpt_tpu_torch.core import spectrum as gspec
from gdpt_tpu_torch.core.math import lift as L
from gdpt_tpu_torch.core.math import where as W
from gdpt_tpu_torch.ops import microfacet as mf
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene import textures as tex

_PI = math.pi


class MatParams(NamedTuple):
    """Per-hit material parameters (textures already evaluated)."""

    kind: torch.Tensor
    eta: torch.Tensor
    refl: torch.Tensor        # (N, 3)
    spec_refl: torch.Tensor   # (N, 3)
    spec_trans: torch.Tensor  # (N, 3)
    roughness: torch.Tensor
    anisotropic: torch.Tensor
    subsurface: torch.Tensor
    metallic: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    specular_transmission: torch.Tensor


class BSDFSample(NamedTuple):
    dir_out: torch.Tensor    # (N, 3)
    eta: torch.Tensor        # 0 = reflection
    roughness: torch.Tensor  # roughness of the chosen lobe
    valid: torch.Tensor      # bool


# Which texture slots each material kind reads (static gating).
_SLOT_USERS = {
    "refl": {M.MAT_LAMBERTIAN, M.MAT_ROUGH_PLASTIC, M.MAT_DISNEY_DIFFUSE,
             M.MAT_DISNEY_METAL, M.MAT_DISNEY_GLASS, M.MAT_DISNEY_SHEEN,
             M.MAT_DISNEY_BSDF},
    "spec_refl": {M.MAT_ROUGH_PLASTIC, M.MAT_ROUGH_DIELECTRIC},
    "spec_trans": {M.MAT_ROUGH_DIELECTRIC},
    "roughness": {M.MAT_ROUGH_PLASTIC, M.MAT_ROUGH_DIELECTRIC,
                  M.MAT_DISNEY_DIFFUSE, M.MAT_DISNEY_METAL,
                  M.MAT_DISNEY_GLASS, M.MAT_DISNEY_BSDF},
    "anisotropic": {M.MAT_DISNEY_METAL, M.MAT_DISNEY_GLASS, M.MAT_DISNEY_BSDF},
    "subsurface": {M.MAT_DISNEY_DIFFUSE, M.MAT_DISNEY_BSDF},
    "metallic": {M.MAT_DISNEY_BSDF},
    "specular": {M.MAT_DISNEY_BSDF},
    "specular_tint": {M.MAT_DISNEY_BSDF},
    "sheen": {M.MAT_DISNEY_BSDF},
    "sheen_tint": {M.MAT_DISNEY_SHEEN, M.MAT_DISNEY_BSDF},
    "clearcoat": {M.MAT_DISNEY_BSDF},
    "clearcoat_gloss": {M.MAT_DISNEY_CLEARCOAT, M.MAT_DISNEY_BSDF},
    "specular_transmission": {M.MAT_DISNEY_BSDF},
}


def gather_params(scene, static, vertex) -> MatParams:
    """Gather + texture-evaluate every lane's material parameters. Slots
    no material kind of the scene reads stay zero and are not gathered."""
    mid = torch.clamp_min(vertex.material_id, 0).long()
    used = set(static.used_material_kinds)
    mt = scene.materials
    uv, fp = vertex.uv, vertex.uv_screen_size
    zero = torch.zeros_like(fp)

    def spec(slot_desc, name):
        if used & _SLOT_USERS[name]:
            return tex.eval_tex3(scene.pool3, slot_desc, mid, uv, fp)
        return _z3(uv)

    def flt(slot_desc, name):
        if used & _SLOT_USERS[name]:
            return tex.eval_tex1(scene.pool1, slot_desc, mid, uv, fp)
        return zero

    return MatParams(
        kind=mt.kind[mid],
        eta=mt.eta[mid],
        refl=spec(mt.refl, "refl"),
        spec_refl=spec(mt.spec_refl, "spec_refl"),
        spec_trans=spec(mt.spec_trans, "spec_trans"),
        roughness=flt(mt.roughness, "roughness"),
        anisotropic=flt(mt.anisotropic, "anisotropic"),
        subsurface=flt(mt.subsurface, "subsurface"),
        metallic=flt(mt.metallic, "metallic"),
        specular=flt(mt.specular, "specular"),
        specular_tint=flt(mt.specular_tint, "specular_tint"),
        sheen=flt(mt.sheen, "sheen"),
        sheen_tint=flt(mt.sheen_tint, "sheen_tint"),
        clearcoat=flt(mt.clearcoat, "clearcoat"),
        clearcoat_gloss=flt(mt.clearcoat_gloss, "clearcoat_gloss"),
        specular_transmission=flt(mt.specular_transmission, "specular_transmission"),
    )


# ---------------------------------------------------------------------------
# Frame helpers
# ---------------------------------------------------------------------------


def _n(frame):
    return frame[:, 2]


def _reflective_frame(vertex, din):
    """Flip the shading frame toward dir_in (opaque materials;
    reference: e.g. src/materials/lambertian.inl:10-13)."""
    frame = vertex.frame
    return W(gm.dot(_n(frame), din) < 0.0, -frame, frame)


def _transmissive_frame(vertex, din):
    """Flip so the frame agrees with the geometric side of dir_in
    (glass-like materials; reference: src/materials/roughdielectric.inl:7-10)."""
    frame = vertex.frame
    flip = gm.dot(_n(frame), din) * gm.dot(vertex.geom_normal, din) < 0.0
    return W(flip, -frame, frame)


def _clamp_rough(r):
    return torch.clamp(r, 0.01, 1.0)


def _aniso_alphas(roughness, anisotropic):
    aspect = torch.sqrt(torch.clamp_min(1.0 - 0.9 * anisotropic, 1e-10))
    r2 = roughness * roughness
    return torch.clamp_min(r2 / aspect, 1e-4), torch.clamp_min(r2 * aspect, 1e-4)


def _safe_div(a, b, eps=1e-20):
    return a / torch.where(torch.abs(b) > eps, b, eps)


def _z3(like):
    return torch.zeros(like.shape[0], 3, dtype=like.dtype, device=like.device)


def _both_out(vertex, din, dout):
    gn = vertex.geom_normal
    return (gm.dot(gn, din) >= 0) & (gm.dot(gn, dout) >= 0)


# ---------------------------------------------------------------------------
# Lambertian (reference: src/materials/lambertian.inl)
# ---------------------------------------------------------------------------


def eval_lambertian(p, din, dout, vertex):
    frame = _reflective_frame(vertex, din)
    ok = _both_out(vertex, din, dout)
    val = L(torch.clamp_min(gm.dot(_n(frame), dout), 0.0)) * p.refl / _PI
    return W(ok, val, 0.0)


def pdf_lambertian(p, din, dout, vertex):
    frame = _reflective_frame(vertex, din)
    ok = _both_out(vertex, din, dout)
    return torch.where(ok, torch.clamp_min(gm.dot(_n(frame), dout), 0.0) / _PI, 0.0)


def sample_lambertian(p, din, vertex, uv, w):
    frame = _reflective_frame(vertex, din)
    d = gm.to_world(frame, gm.sample_cos_hemisphere(uv))
    ok = gm.dot(vertex.geom_normal, din) >= 0
    return BSDFSample(d, torch.zeros_like(w), torch.ones_like(w), ok)


# ---------------------------------------------------------------------------
# RoughPlastic (reference: src/materials/roughplastic.inl)
# ---------------------------------------------------------------------------


def eval_rough_plastic(p, din, dout, vertex):
    frame = _reflective_frame(vertex, din)
    half = gm.normalize(din + dout, eps=1e-20)
    n_dot_h = gm.dot(_n(frame), half)
    n_dot_in = gm.dot(_n(frame), din)
    n_dot_out = gm.dot(_n(frame), dout)
    ok = _both_out(vertex, din, dout) & (n_dot_out > 0) & (n_dot_h > 0)
    rough = _clamp_rough(p.roughness)
    f_o = mf.fresnel_dielectric(gm.dot(half, dout), p.eta)
    d = mf.gtr2(n_dot_h, rough)
    g = mf.smith_masking_gtr2(gm.to_local(frame, din), rough) * mf.smith_masking_gtr2(
        gm.to_local(frame, dout), rough)
    spec = p.spec_refl * L(_safe_div(g * f_o * d, 4.0 * n_dot_in * n_dot_out))
    f_i = mf.fresnel_dielectric(gm.dot(half, din), p.eta)
    diff = p.refl * L((1.0 - f_o) * (1.0 - f_i)) / _PI
    return W(ok, (spec + diff) * L(n_dot_out), 0.0)


def pdf_rough_plastic(p, din, dout, vertex):
    frame = _reflective_frame(vertex, din)
    half = gm.normalize(din + dout, eps=1e-20)
    n_dot_h = gm.dot(_n(frame), half)
    n_dot_in = gm.dot(_n(frame), din)
    n_dot_out = gm.dot(_n(frame), dout)
    l_s = gspec.luminance(p.spec_refl)
    l_r = gspec.luminance(p.refl)
    ok = (_both_out(vertex, din, dout) & (n_dot_out > 0) & (n_dot_h > 0)
          & (l_s + l_r > 0))
    rough = _clamp_rough(p.roughness)
    spec_prob = _safe_div(l_s, l_s + l_r)
    g_in = mf.smith_masking_gtr2(gm.to_local(frame, din), rough)
    d = mf.gtr2(n_dot_h, rough)
    spec_prob = spec_prob * _safe_div(g_in * d, 4.0 * n_dot_in)
    diff_prob = _safe_div(l_r, l_s + l_r) * torch.clamp_min(n_dot_out, 0.0) / _PI
    return torch.where(ok, spec_prob + diff_prob, 0.0)


def sample_rough_plastic(p, din, vertex, uv, w):
    frame = _reflective_frame(vertex, din)
    l_s = gspec.luminance(p.spec_refl)
    l_r = gspec.luminance(p.refl)
    ok = (gm.dot(vertex.geom_normal, din) >= 0) & (l_s + l_r > 0)
    spec_prob = _safe_div(l_s, l_s + l_r)
    rough = _clamp_rough(p.roughness)
    local_in = gm.to_local(frame, din)
    half = gm.to_world(frame, mf.sample_visible_normals(local_in, rough * rough, uv))
    refl = mf.reflect_over(din, half)
    diff = gm.to_world(frame, gm.sample_cos_hemisphere(uv))
    take_spec = w < spec_prob
    d = W(take_spec, refl, diff)
    roughness = torch.where(take_spec, rough, 1.0)
    return BSDFSample(d, torch.zeros_like(w), roughness, ok)


# ---------------------------------------------------------------------------
# RoughDielectric (reference: src/materials/roughdielectric.inl)
# ---------------------------------------------------------------------------


def _dielectric_common(p, din, dout, vertex):
    gn = vertex.geom_normal
    reflect = gm.dot(gn, din) * gm.dot(gn, dout) > 0
    frame = _transmissive_frame(vertex, din)
    eta = torch.where(gm.dot(gn, din) > 0, p.eta, 1.0 / p.eta)
    half = W(reflect, gm.normalize(din + dout, eps=1e-20),
             gm.normalize(din + dout * L(eta), eps=1e-20))
    half = W(gm.dot(half, _n(frame)) < 0, -half, half)
    return reflect, frame, eta, half


def eval_rough_dielectric(p, din, dout, vertex):
    reflect, frame, eta, half = _dielectric_common(p, din, dout, vertex)
    rough = _clamp_rough(p.roughness)
    h_dot_in = gm.dot(half, din)
    f = mf.fresnel_dielectric(h_dot_in, eta)
    d = mf.gtr2(gm.dot(_n(frame), half), rough)
    g = mf.smith_masking_gtr2(gm.to_local(frame, din), rough) * mf.smith_masking_gtr2(
        gm.to_local(frame, dout), rough)
    n_dot_in = torch.abs(gm.dot(_n(frame), din))
    refl_val = p.spec_refl * L(_safe_div(f * d * g, 4.0 * n_dot_in))
    h_dot_out = gm.dot(half, dout)
    sqrt_denom = h_dot_in + eta * h_dot_out
    # Radiance transport carries the 1/eta^2 contraction
    # (reference: src/materials/roughdielectric.inl:56-70).
    eta_factor = 1.0 / (eta * eta)
    trans_val = p.spec_trans * L(_safe_div(
        eta_factor * (1.0 - f) * d * g * eta * eta * torch.abs(h_dot_out * h_dot_in),
        n_dot_in * sqrt_denom * sqrt_denom,
    ))
    return W(reflect, refl_val, trans_val)


def pdf_rough_dielectric(p, din, dout, vertex):
    reflect, frame, eta, half = _dielectric_common(p, din, dout, vertex)
    rough = _clamp_rough(p.roughness)
    h_dot_in = gm.dot(half, din)
    f = mf.fresnel_dielectric(h_dot_in, eta)
    d = mf.gtr2(gm.dot(half, _n(frame)), rough)
    g_in = mf.smith_masking_gtr2(gm.to_local(frame, din), rough)
    n_dot_in = gm.dot(_n(frame), din)
    refl_pdf = _safe_div(f * d * g_in, 4.0 * torch.abs(n_dot_in))
    h_dot_out = gm.dot(half, dout)
    sqrt_denom = h_dot_in + eta * h_dot_out
    dh_dout = _safe_div(eta * eta * h_dot_out, sqrt_denom * sqrt_denom)
    trans_pdf = (1.0 - f) * d * g_in * torch.abs(_safe_div(dh_dout * h_dot_in, n_dot_in))
    return torch.where(reflect, refl_pdf, trans_pdf)


def _sample_dielectric(din, vertex, eta_in, rough, uv, w, ax=None, ay=None):
    """The Fresnel-chosen reflection or refraction of a VNDF half-vector,
    shared by RoughDielectric and DisneyGlass."""
    gn = vertex.geom_normal
    frame = _transmissive_frame(vertex, din)
    eta = torch.where(gm.dot(gn, din) > 0, eta_in, 1.0 / eta_in)
    local_in = gm.to_local(frame, din)
    half = gm.to_world(frame, mf.sample_visible_normals(
        local_in, rough * rough, uv, ax, ay))
    half = W(gm.dot(half, _n(frame)) < 0, -half, half)
    h_dot_in = gm.dot(half, din)
    f = mf.fresnel_dielectric(h_dot_in, eta)
    reflected = mf.reflect_over(din, half)
    h_dot_out_sq = 1.0 - (1.0 - h_dot_in * h_dot_in) / (eta * eta)
    half_t = W(h_dot_in < 0, -half, half)
    h_dot_out = gm.safe_sqrt(h_dot_out_sq)
    refracted = gm.normalize(
        -din / L(eta) + L(torch.abs(h_dot_in) / eta - h_dot_out) * half_t, eps=1e-20)
    take_refl = w <= f
    d = W(take_refl, reflected, refracted)
    out_eta = torch.where(take_refl, 0.0, eta)
    valid = take_refl | (h_dot_out_sq > 0)
    return BSDFSample(d, out_eta, rough, valid)


def sample_rough_dielectric(p, din, vertex, uv, w):
    return _sample_dielectric(din, vertex, p.eta, _clamp_rough(p.roughness), uv, w)


# ---------------------------------------------------------------------------
# DisneyDiffuse (reference: src/materials/disney_diffuse.inl)
# ---------------------------------------------------------------------------


def eval_disney_diffuse(p, din, dout, vertex):
    frame = _reflective_frame(vertex, din)
    ok = _both_out(vertex, din, dout)
    half = gm.normalize(din + dout, eps=1e-20)
    n_in = torch.abs(gm.dot(_n(frame), din))
    n_out = torch.abs(gm.dot(_n(frame), dout))
    h_out = torch.abs(gm.dot(half, dout))
    rough = _clamp_rough(p.roughness)
    fd90 = 0.5 + 2.0 * rough * h_out * h_out
    pow5_out = (1.0 - n_out) ** 5
    pow5_in = (1.0 - n_in) ** 5
    fd_out = 1.0 + (fd90 - 1.0) * pow5_out
    fd_in = 1.0 + (fd90 - 1.0) * pow5_in
    base = p.refl * L(fd_in * fd_out * n_out) / _PI
    fss90 = rough * h_out * h_out
    fss_in = 1.0 + (fss90 - 1.0) * pow5_in
    fss_out = 1.0 + (fss90 - 1.0) * pow5_out
    ss = ((1.25 * p.refl / _PI)
          * L(fss_in * fss_out * (_safe_div(torch.ones_like(n_in), n_in + n_out) - 0.5) + 0.5)
          * L(n_out))
    val = L(1.0 - p.subsurface) * base + L(p.subsurface) * ss
    return W(ok, val, 0.0)


def pdf_disney_diffuse(p, din, dout, vertex):
    return pdf_lambertian(p, din, dout, vertex)


def sample_disney_diffuse(p, din, vertex, uv, w):
    s = sample_lambertian(p, din, vertex, uv, w)
    return s._replace(roughness=_clamp_rough(p.roughness))


# ---------------------------------------------------------------------------
# DisneyMetal (reference: src/materials/disney_metal.inl)
# ---------------------------------------------------------------------------


def eval_disney_metal(p, din, dout, vertex, base_color=None):
    frame = _reflective_frame(vertex, din)
    ok = _both_out(vertex, din, dout)
    base = p.refl if base_color is None else base_color
    half = gm.normalize(din + dout, eps=1e-20)
    n_in = torch.abs(gm.dot(_n(frame), din))
    h_out = torch.abs(gm.dot(half, dout))
    rough = _clamp_rough(p.roughness)
    ax, ay = _aniso_alphas(rough, p.anisotropic)
    f_m = base + (1.0 - base) * L((1.0 - h_out) ** 5)
    d = mf.gtr2_aniso(gm.to_local(frame, half), ax, ay)
    g = mf.smith_masking_aniso(gm.to_local(frame, din), ax, ay) * mf.smith_masking_aniso(
        gm.to_local(frame, dout), ax, ay)
    return W(ok, f_m * L(_safe_div(d * g, 4.0 * n_in)), 0.0)


def pdf_disney_metal(p, din, dout, vertex):
    frame = _reflective_frame(vertex, din)
    ok = _both_out(vertex, din, dout)
    half = gm.normalize(din + dout, eps=1e-20)
    rough = _clamp_rough(p.roughness)
    ax, ay = _aniso_alphas(rough, p.anisotropic)
    d = mf.gtr2_aniso(gm.to_local(frame, half), ax, ay)
    g_in = mf.smith_masking_aniso(gm.to_local(frame, din), ax, ay)
    n_in = torch.abs(gm.dot(_n(frame), din))
    return torch.where(ok, _safe_div(g_in * d, 4.0 * n_in), 0.0)


def sample_disney_metal(p, din, vertex, uv, w):
    frame = _reflective_frame(vertex, din)
    rough = _clamp_rough(p.roughness)
    ax, ay = _aniso_alphas(rough, p.anisotropic)
    local_in = gm.to_local(frame, din)
    half = gm.to_world(frame, mf.sample_visible_normals(
        local_in, rough * rough, uv, ax, ay))
    d = mf.reflect_over(din, half)
    ok = gm.dot(vertex.geom_normal, din) >= 0
    return BSDFSample(d, torch.zeros_like(w), rough, ok)


# ---------------------------------------------------------------------------
# DisneyGlass (reference: src/materials/disney_glass.inl): anisotropic
# rough dielectric with base_color reflection / sqrt(base_color) refraction.
# ---------------------------------------------------------------------------


def eval_disney_glass(p, din, dout, vertex):
    reflect, frame, eta, half = _dielectric_common(p, din, dout, vertex)
    rough = _clamp_rough(p.roughness)
    ax, ay = _aniso_alphas(rough, p.anisotropic)
    h_dot_in = gm.dot(half, din)
    f = mf.fresnel_dielectric(h_dot_in, eta)
    d = mf.gtr2_aniso(gm.to_local(frame, half), ax, ay)
    g = mf.smith_masking_aniso(gm.to_local(frame, din), ax, ay) * mf.smith_masking_aniso(
        gm.to_local(frame, dout), ax, ay)
    n_dot_in = torch.abs(gm.dot(_n(frame), din))
    refl_val = p.refl * L(_safe_div(f * d * g, 4.0 * n_dot_in))
    h_dot_out = gm.dot(half, dout)
    sqrt_denom = h_dot_in + eta * h_dot_out
    trans_val = torch.sqrt(torch.clamp_min(p.refl, 0.0)) * L(_safe_div(
        (1.0 - f) * d * g * torch.abs(h_dot_out * h_dot_in),
        n_dot_in * sqrt_denom * sqrt_denom,
    ))
    return W(reflect, refl_val, trans_val)


def pdf_disney_glass(p, din, dout, vertex):
    reflect, frame, eta, half = _dielectric_common(p, din, dout, vertex)
    rough = _clamp_rough(p.roughness)
    ax, ay = _aniso_alphas(rough, p.anisotropic)
    h_dot_in = gm.dot(half, din)
    f = mf.fresnel_dielectric(h_dot_in, eta)
    d = mf.gtr2_aniso(gm.to_local(frame, half), ax, ay)
    g_in = mf.smith_masking_aniso(gm.to_local(frame, din), ax, ay)
    n_dot_in = gm.dot(_n(frame), din)
    refl_pdf = _safe_div(f * d * g_in, 4.0 * torch.abs(n_dot_in))
    h_dot_out = gm.dot(half, dout)
    sqrt_denom = h_dot_in + eta * h_dot_out
    trans_pdf = (1.0 - f) * d * g_in * torch.abs(
        _safe_div(eta * eta * h_dot_out * h_dot_in, sqrt_denom * sqrt_denom * n_dot_in))
    return torch.where(reflect, refl_pdf, trans_pdf)


def sample_disney_glass(p, din, vertex, uv, w):
    rough = _clamp_rough(p.roughness)
    ax, ay = _aniso_alphas(rough, p.anisotropic)
    return _sample_dielectric(din, vertex, p.eta, rough, uv, w, ax, ay)


# ---------------------------------------------------------------------------
# DisneyClearcoat (reference: src/materials/disney_clearcoat.inl)
# ---------------------------------------------------------------------------


def _clearcoat_alpha(gloss):
    return (1.0 - gloss) * 0.1 + gloss * 0.001


def eval_disney_clearcoat(p, din, dout, vertex):
    frame = _reflective_frame(vertex, din)
    ok = _both_out(vertex, din, dout)
    half = gm.normalize(din + dout, eps=1e-20)
    h_out = torch.abs(gm.dot(half, dout))
    r0 = 0.04  # ((1.5-1)/(1.5+1))^2
    f_c = r0 + (1.0 - r0) * (1.0 - h_out) ** 5
    alpha = _clearcoat_alpha(p.clearcoat_gloss)
    hz = gm.to_local(frame, half)[:, 2]
    d_c = mf.gtr1_clearcoat(hz, alpha)
    # Fixed-roughness (0.25) Smith masking for the clearcoat lobe.
    g_c = mf.smith_masking_aniso(gm.to_local(frame, din), 0.25, 0.25) * \
        mf.smith_masking_aniso(gm.to_local(frame, dout), 0.25, 0.25)
    n_in = torch.abs(gm.dot(_n(frame), din))
    val = _safe_div(f_c * d_c * g_c, 4.0 * n_in)
    return W(ok, L(val).expand(-1, 3), 0.0)


def pdf_disney_clearcoat(p, din, dout, vertex):
    frame = _reflective_frame(vertex, din)
    ok = _both_out(vertex, din, dout)
    half = gm.normalize(din + dout, eps=1e-20)
    alpha = _clearcoat_alpha(p.clearcoat_gloss)
    hz = gm.to_local(frame, half)[:, 2]
    d_c = mf.gtr1_clearcoat(hz, alpha)
    n_h = torch.abs(gm.dot(_n(frame), half))
    # The reference's consistent half-vector pdf D * |n.h| / (4 |h.out|)
    # (gdpt_tpu/ops/materials.py:pdf_disney_clearcoat).
    h_out = torch.abs(gm.dot(half, dout))
    return torch.where(ok, _safe_div(d_c * n_h, 4.0 * h_out), 0.0)


def sample_disney_clearcoat(p, din, vertex, uv, w):
    frame = _reflective_frame(vertex, din)
    alpha = _clearcoat_alpha(p.clearcoat_gloss)
    half = gm.to_world(frame, mf.sample_clearcoat_normal(alpha, uv))
    d = mf.reflect_over(din, half)
    ok = gm.dot(vertex.geom_normal, din) >= 0
    return BSDFSample(d, torch.zeros_like(w), alpha, ok)


# ---------------------------------------------------------------------------
# DisneySheen (reference: src/materials/disney_sheen.inl)
# ---------------------------------------------------------------------------


def _c_tint(base_color):
    lum = L(gspec.luminance(base_color))
    return torch.where(lum > 0, base_color / torch.where(lum > 0, lum, 1.0), 1.0)


def eval_disney_sheen(p, din, dout, vertex):
    frame = _reflective_frame(vertex, din)
    ok = _both_out(vertex, din, dout)
    half = gm.normalize(din + dout, eps=1e-20)
    h_out = torch.abs(gm.dot(half, dout))
    n_out = torch.abs(gm.dot(_n(frame), dout))
    c_sheen = L(1.0 - p.sheen_tint) + L(p.sheen_tint) * _c_tint(p.refl)
    return W(ok, c_sheen * L((1.0 - h_out) ** 5) * L(n_out), 0.0)


def pdf_disney_sheen(p, din, dout, vertex):
    return pdf_lambertian(p, din, dout, vertex)


def sample_disney_sheen(p, din, vertex, uv, w):
    return sample_lambertian(p, din, vertex, uv, w)


# ---------------------------------------------------------------------------
# DisneyBSDF (reference: src/materials/disney_bsdf.inl): five lobes, chosen
# with probabilities proportional to the weights of the pdf (as in
# gdpt_tpu, unlike the reference's uniform 1/4 choice).
# ---------------------------------------------------------------------------


def _disney_weights(p):
    diffuse_w = (1.0 - p.specular_transmission) * (1.0 - p.metallic)
    metal_w = 1.0 - p.specular_transmission * (1.0 - p.metallic)
    clearcoat_w = 0.25 * p.clearcoat
    glass_w = (1.0 - p.metallic) * p.specular_transmission
    return diffuse_w, metal_w, clearcoat_w, glass_w


def _disney_metal_color(p, din, vertex):
    eta = torch.where(gm.dot(vertex.geom_normal, din) > 0, p.eta, 1.0 / p.eta)
    ks = L(1.0 - p.specular_tint) + L(p.specular_tint) * _c_tint(p.refl)
    r0 = ((eta - 1.0) / (eta + 1.0)) ** 2
    return L(p.specular * r0 * (1.0 - p.metallic)) * ks + L(p.metallic) * p.refl


def eval_disney_bsdf(p, din, dout, vertex):
    below = gm.dot(vertex.geom_normal, din) <= 0
    dw, mw, cw, gw = (L(x) for x in _disney_weights(p))
    sheen_w = L((1.0 - p.metallic) * p.sheen)
    glass = eval_disney_glass(p, din, dout, vertex)
    diffuse = eval_disney_diffuse(p, din, dout, vertex)
    metal = eval_disney_metal(p, din, dout, vertex,
                              base_color=_disney_metal_color(p, din, vertex))
    clearcoat = eval_disney_clearcoat(p, din, dout, vertex)
    sheen = eval_disney_sheen(p, din, dout, vertex)
    full = dw * diffuse + mw * metal + cw * clearcoat + gw * glass + sheen_w * sheen
    return W(below, gw * glass, full)


def pdf_disney_bsdf(p, din, dout, vertex):
    below = gm.dot(vertex.geom_normal, din) <= 0
    dw, mw, cw, gw = _disney_weights(p)
    total = torch.clamp_min(dw + mw + cw + gw, 1e-20)
    mix = (
        dw * pdf_disney_diffuse(p, din, dout, vertex)
        + mw * pdf_disney_metal(p, din, dout, vertex)
        + cw * pdf_disney_clearcoat(p, din, dout, vertex)
        + gw * pdf_disney_glass(p, din, dout, vertex)
    ) / total
    return torch.where(below, pdf_disney_glass(p, din, dout, vertex), mix)


def _pick(cond, a: BSDFSample, b: BSDFSample) -> BSDFSample:
    return BSDFSample(*(W(cond, fa, fb) for fa, fb in zip(a, b)))


def sample_disney_bsdf(p, din, vertex, uv, w):
    below = gm.dot(vertex.geom_normal, din) <= 0
    dw, mw, cw, gw = _disney_weights(p)
    total = torch.clamp_min(dw + mw + cw + gw, 1e-20)
    c1 = dw / total
    c2 = c1 + mw / total
    c3 = c2 + cw / total
    # Rescale w within the chosen interval so the glass lobe still gets a
    # fresh uniform for its Fresnel reflect/refract decision.
    w_glass = torch.clamp(_safe_div(w - c3, 1.0 - c3), 0.0, 1.0)
    s_diff = sample_disney_diffuse(p, din, vertex, uv, w)
    s_metal = sample_disney_metal(p, din, vertex, uv, w)
    s_cc = sample_disney_clearcoat(p, din, vertex, uv, w)
    s_glass = sample_disney_glass(p, din, vertex, uv, torch.where(below, w, w_glass))
    out = _pick(w < c1, s_diff, _pick(w < c2, s_metal, _pick(w < c3, s_cc, s_glass)))
    return _pick(below, s_glass, out)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_EVAL = {
    M.MAT_LAMBERTIAN: eval_lambertian,
    M.MAT_ROUGH_PLASTIC: eval_rough_plastic,
    M.MAT_ROUGH_DIELECTRIC: eval_rough_dielectric,
    M.MAT_DISNEY_DIFFUSE: eval_disney_diffuse,
    M.MAT_DISNEY_METAL: eval_disney_metal,
    M.MAT_DISNEY_GLASS: eval_disney_glass,
    M.MAT_DISNEY_CLEARCOAT: eval_disney_clearcoat,
    M.MAT_DISNEY_SHEEN: eval_disney_sheen,
    M.MAT_DISNEY_BSDF: eval_disney_bsdf,
}

_PDF = {
    M.MAT_LAMBERTIAN: pdf_lambertian,
    M.MAT_ROUGH_PLASTIC: pdf_rough_plastic,
    M.MAT_ROUGH_DIELECTRIC: pdf_rough_dielectric,
    M.MAT_DISNEY_DIFFUSE: pdf_disney_diffuse,
    M.MAT_DISNEY_METAL: pdf_disney_metal,
    M.MAT_DISNEY_GLASS: pdf_disney_glass,
    M.MAT_DISNEY_CLEARCOAT: pdf_disney_clearcoat,
    M.MAT_DISNEY_SHEEN: pdf_disney_sheen,
    M.MAT_DISNEY_BSDF: pdf_disney_bsdf,
}

_SAMPLE = {
    M.MAT_LAMBERTIAN: sample_lambertian,
    M.MAT_ROUGH_PLASTIC: sample_rough_plastic,
    M.MAT_ROUGH_DIELECTRIC: sample_rough_dielectric,
    M.MAT_DISNEY_DIFFUSE: sample_disney_diffuse,
    M.MAT_DISNEY_METAL: sample_disney_metal,
    M.MAT_DISNEY_GLASS: sample_disney_glass,
    M.MAT_DISNEY_CLEARCOAT: sample_disney_clearcoat,
    M.MAT_DISNEY_SHEEN: sample_disney_sheen,
    M.MAT_DISNEY_BSDF: sample_disney_bsdf,
}


def eval_bsdf(params: MatParams, din, dout, vertex, used_kinds):
    """BSDF * |cos| for each lane's material; only `used_kinds` evaluated."""
    out = _z3(din)
    for k in used_kinds:
        out = W(params.kind == k, _EVAL[k](params, din, dout, vertex), out)
    return out


def pdf_bsdf(params: MatParams, din, dout, vertex, used_kinds):
    out = torch.zeros_like(din[:, 0])
    for k in used_kinds:
        out = torch.where(params.kind == k, _PDF[k](params, din, dout, vertex), out)
    return out


def sample_bsdf(params: MatParams, din, vertex, uv, w, used_kinds) -> BSDFSample:
    zero = torch.zeros_like(w)
    up = _z3(din)
    up[:, 2] = 1.0
    out = BSDFSample(up, zero, zero + 1.0, torch.zeros_like(w, dtype=torch.bool))
    for k in used_kinds:
        s = _SAMPLE[k](params, din, vertex, uv, w)
        out = _pick(params.kind == k, s, out)
    return out
