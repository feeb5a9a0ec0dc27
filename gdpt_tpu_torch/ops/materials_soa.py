"""Batched (SoA) material stack.

Counterpart of gdpt_tpu/ops/materials_soa.py, with the same conventions:
eval returns BSDF * |cos|, pdf is in solid angle, sample returns
(dir, eta, roughness, valid-mask f32). All nine material kinds of
scene/model.py (Lambertian, rough plastic, rough dielectric and the
Disney family), and constant, checkerboard and image texture slots for
spectrum and float parameters alike, with trilinear mip filtering when
the caller passes a footprint.

Expressions keep the reference's clamps and their order: a NaN in one
lane becomes a black or white pixel only at the end of a render.
"""

import math
from typing import NamedTuple

import torch

from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import INT, REAL
from gdpt_tpu_torch.core.soa import V3, Frame
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene import textures as tex


class MatParamsSoA(NamedTuple):
    kind: torch.Tensor
    eta: torch.Tensor
    refl: V3
    spec_refl: V3
    spec_trans: V3
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


class BSDFSampleSoA(NamedTuple):
    dir_out: V3
    eta: torch.Tensor
    roughness: torch.Tensor
    valid: torch.Tensor  # f32 mask


class MaterialTablesSoA(NamedTuple):
    """Component views of the scene material table."""

    kind: torch.Tensor
    eta: torch.Tensor
    spec_kind: tuple      # 3 x (m,) texture kinds
    spec_c0: tuple        # 3 x V3
    spec_c1: tuple        # 3 x V3
    spec_uv: tuple        # 3 x (uscale, vscale, uoffset, voffset)
    spec_img: tuple       # 3 x (m,) pool image ids
    float_const: tuple    # 11 x (m,) const value / checker color0
    float_kind: tuple     # 11 x (m,) texture kinds
    float_c1: tuple       # 11 x (m,) checker color1
    float_uv: tuple       # 11 x (uscale, vscale, uoffset, voffset)
    float_img: tuple      # 11 x (m,) pool-1 image ids
    pool3: object         # textures_soa.Pool3SoA
    pool1: object         # textures_soa.Pool1SoA


_FLOAT_SLOTS = [
    "roughness", "anisotropic", "subsurface", "metallic", "specular",
    "specular_tint", "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss",
    "specular_transmission",
]
_SPEC_SLOTS = ["refl", "spec_refl", "spec_trans"]

# Which texture slots each material kind reads (gdpt_tpu/ops/materials.py:59).
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


def build_material_tables(scene_device) -> MaterialTablesSoA:
    from gdpt_tpu_torch.ops import textures_soa as tsoa

    mt = scene_device.materials
    spec_kind, spec_c0, spec_c1, spec_uv, spec_img = [], [], [], [], []
    for s in _SPEC_SLOTS:
        d: tex.TexDesc = getattr(mt, s)
        spec_kind.append(d.kind)
        spec_c0.append(soa.from_rows(d.value))
        spec_c1.append(soa.from_rows(d.value2))
        spec_uv.append((d.uscale, d.vscale, d.uoffset, d.voffset))
        spec_img.append(d.img_id)
    float_const, float_kind, float_c1, float_uv, float_img = [], [], [], [], []
    for s in _FLOAT_SLOTS:
        d: tex.TexDesc = getattr(mt, s)
        float_const.append(d.value[:, 0].contiguous())
        float_kind.append(d.kind)
        float_c1.append(d.value2[:, 0].contiguous())
        float_uv.append((d.uscale, d.vscale, d.uoffset, d.voffset))
        float_img.append(d.img_id)
    return MaterialTablesSoA(
        mt.kind, mt.eta, tuple(spec_kind), tuple(spec_c0), tuple(spec_c1),
        tuple(spec_uv), tuple(spec_img), tuple(float_const),
        tuple(float_kind), tuple(float_c1), tuple(float_uv),
        tuple(float_img), tsoa.pool3_soa(scene_device.pool3),
        tsoa.pool1_soa(scene_device.pool1),
    )


def supports_soa_materials(scene) -> bool:
    """The SoA stack covers every material kind and the full texture
    envelope; kept for API parity with the reference."""
    return True


def _checker_sign(lu, lv):
    """cx * cy of the reference's checkerboard (src/texture.h:141-152)."""
    cx = 2 * torch.remainder((lu * 2).to(INT), 2) - 1
    cy = 2 * torch.remainder((lv * 2).to(INT), 2) - 1
    return cx * cy


def _eval_spec_slot(tables: MaterialTablesSoA, slot, mid, uv_u, uv_v,
                    img_used: bool, fp=None) -> V3:
    from gdpt_tpu_torch.ops import textures_soa as tsoa

    i = _SPEC_SLOTS.index(slot)
    kind = soa.take(tables.spec_kind[i], mid)
    c0 = soa.gather(tables.spec_c0[i], mid)
    c1 = soa.gather(tables.spec_c1[i], mid)
    us, vs, uo, vo = tables.spec_uv[i]
    usg, vsg = soa.take(us, mid), soa.take(vs, mid)
    lu = torch.remainder(uv_u * usg + soa.take(uo, mid), 1.0)
    lv = torch.remainder(uv_v * vsg + soa.take(vo, mid), 1.0)
    checker = soa.where(_checker_sign(lu, lv) == 1, c0, c1)
    out = soa.where(kind == tex.TEX_CHECKER, checker, c0)
    # The image branch runs only when some material uses it
    # (img_used: SceneStatic.spec_image_slots).
    if img_used:
        iid = soa.take(tables.spec_img[i], mid)
        if fp is None:
            img = tsoa.bilinear_level0(tables.pool3, iid, lu, lv)
        else:
            level = tsoa.footprint_level(tables.pool3, iid, usg, vsg, fp)
            img = tsoa.trilinear(tables.pool3, iid, lu, lv, level)
        out = soa.where(kind == tex.TEX_IMAGE, img, out)
    return out


def _eval_float_slot(tables: MaterialTablesSoA, i, mid, uv_u, uv_v,
                     slot_mode: int, fp=None):
    """slot_mode: OR of 1 (any checker) | 2 (any image) over the scene;
    a texture branch runs only when a material of the scene uses it."""
    from gdpt_tpu_torch.ops import textures_soa as tsoa

    c0 = soa.take(tables.float_const[i], mid)
    if not slot_mode:
        return c0
    kind = soa.take(tables.float_kind[i], mid)
    us, vs, uo, vo = tables.float_uv[i]
    usg, vsg = soa.take(us, mid), soa.take(vs, mid)
    lu = torch.remainder(uv_u * usg + soa.take(uo, mid), 1.0)
    lv = torch.remainder(uv_v * vsg + soa.take(vo, mid), 1.0)
    out = c0
    if slot_mode & 1:
        c1 = soa.take(tables.float_c1[i], mid)
        checker = torch.where(_checker_sign(lu, lv) == 1, c0, c1)
        out = torch.where(kind == tex.TEX_CHECKER, checker, out)
    if slot_mode & 2:
        iid = soa.take(tables.float_img[i], mid)
        if fp is None:
            img = tsoa.bilinear_level0_f(tables.pool1, iid, lu, lv)
        else:
            level = tsoa.footprint_level(tables.pool1, iid, usg, vsg, fp)
            img = tsoa.trilinear_f(tables.pool1, iid, lu, lv, level)
        out = torch.where(kind == tex.TEX_IMAGE, img, out)
    return out


def gather_params_soa(tables: MaterialTablesSoA, used_kinds, material_id,
                      uv_u, uv_v, spec_image_slots=(False, False, False),
                      float_tex_slots=None, fp=None) -> MatParamsSoA:
    """Each lane's material parameters at its uv. fp: the per-lane
    uv-space footprint (mip-filtered image lookups), or None for level 0."""
    mid = torch.clamp_min(material_id, 0)
    used = set(used_kinds)
    zero = torch.zeros(mid.shape[0], dtype=REAL, device=mid.device)
    zero3 = V3(zero, zero, zero)

    def spec(slot):
        if used & _SLOT_USERS[slot]:
            return _eval_spec_slot(tables, slot, mid, uv_u, uv_v,
                                   spec_image_slots[_SPEC_SLOTS.index(slot)], fp=fp)
        return zero3

    def flt(slot):
        if used & _SLOT_USERS[slot]:
            i = _FLOAT_SLOTS.index(slot)
            mode = float_tex_slots[i] if float_tex_slots else 0
            return _eval_float_slot(tables, i, mid, uv_u, uv_v, mode, fp=fp)
        return zero

    return MatParamsSoA(
        kind=soa.take(tables.kind, mid),
        eta=soa.take(tables.eta, mid),
        refl=spec("refl"),
        spec_refl=spec("spec_refl"),
        spec_trans=spec("spec_trans"),
        roughness=flt("roughness"),
        anisotropic=flt("anisotropic"),
        subsurface=flt("subsurface"),
        metallic=flt("metallic"),
        specular=flt("specular"),
        specular_tint=flt("specular_tint"),
        sheen=flt("sheen"),
        sheen_tint=flt("sheen_tint"),
        clearcoat=flt("clearcoat"),
        clearcoat_gloss=flt("clearcoat_gloss"),
        specular_transmission=flt("specular_transmission"),
    )


# ---------------------------------------------------------------------------
# Microfacet helpers (reference: gdpt_tpu/ops/materials_soa.py:225-330)
# ---------------------------------------------------------------------------


def _pow5(x):
    """x ** 5 as XLA's integer_pow computes it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def _fresnel_dielectric(n_dot_i, eta):
    n_dot_t_sq = 1.0 - (1.0 - n_dot_i * n_dot_i) / (eta * eta)
    n_dot_t = torch.sqrt(torch.clamp_min(n_dot_t_sq, 0.0))
    ni = torch.abs(n_dot_i)
    rs = (ni - eta * n_dot_t) / torch.clamp_min(ni + eta * n_dot_t, 1e-20)
    rp = (eta * ni - n_dot_t) / torch.clamp_min(eta * ni + n_dot_t, 1e-20)
    return torch.where(n_dot_t_sq < 0.0, 1.0, 0.5 * (rs * rs + rp * rp))


def _gtr2(n_dot_h, roughness):
    alpha = roughness * roughness
    a2 = alpha * alpha
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    return a2 / torch.clamp_min(math.pi * t * t, 1e-20)


def _gtr2_aniso(h_local: V3, ax, ay):
    d = (h_local.x / ax) ** 2 + (h_local.y / ay) ** 2 + h_local.z * h_local.z
    return 1.0 / torch.clamp_min(math.pi * ax * ay * d * d, 1e-20)


def _smith_g1(v_local: V3, roughness):
    alpha = roughness * roughness
    a2 = alpha * alpha
    lam = (-1.0 + torch.sqrt(
        1.0 + (v_local.x ** 2 * a2 + v_local.y ** 2 * a2)
        / torch.clamp_min(v_local.z ** 2, 1e-20)
    )) / 2.0
    return 1.0 / (1.0 + lam)


def _smith_g1_aniso(v_local: V3, ax, ay):
    inner = ((v_local.x * ax) ** 2 + (v_local.y * ay) ** 2) / torch.clamp_min(
        v_local.z ** 2, 1e-20)
    return 1.0 / (1.0 + (torch.sqrt(1.0 + inner) - 1.0) / 2.0)


def _vndf_sample(local_in: V3, ax, ay, u0, u1) -> V3:
    below = local_in.z < 0.0
    din = soa.where(below, -local_in, local_in)
    hemi = soa.normalize(V3(ax * din.x, ay * din.y, din.z))
    r = torch.sqrt(u0)
    phi = 2.0 * math.pi * u1
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + hemi.z)
    t2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - t1 * t1, 0.0)) + s * t2
    disk = V3(t1, t2, torch.sqrt(torch.clamp_min(1.0 - t1 * t1 - t2 * t2, 0.0)))
    hemi_frame = soa.coordinate_system(hemi)
    hn = soa.to_world(hemi_frame, disk)
    out = soa.normalize(V3(ax * hn.x, ay * hn.y, torch.clamp_min(hn.z, 0.0)))
    return soa.where(below, -out, out)


def _reflect_over(din: V3, half: V3) -> V3:
    return soa.normalize(-din + half * (2.0 * soa.dot(din, half)))


def _aniso_alphas(roughness, anisotropic):
    aspect = torch.sqrt(torch.clamp_min(1.0 - 0.9 * anisotropic, 1e-10))
    r2 = roughness * roughness
    return torch.clamp_min(r2 / aspect, 1e-4), torch.clamp_min(r2 * aspect, 1e-4)


def _clamp_rough(r):
    return torch.clamp(r, 0.01, 1.0)


def _safe_div(a, b):
    return a / torch.where(torch.abs(b) > 1e-20, b, 1e-20)


def _cos_hemisphere(frame: Frame, u0, u1) -> V3:
    phi = 2.0 * math.pi * u0
    r = torch.sqrt(u1)
    return soa.to_world(
        frame, V3(r * torch.cos(phi), r * torch.sin(phi),
                  torch.sqrt(torch.clamp(1.0 - u1, 0.0, 1.0)))
    )


def _refl_frame(frame: Frame, din: V3) -> Frame:
    return soa.flip(frame, soa.dot(frame.n, din) < 0.0)


def _trans_frame(frame: Frame, gn: V3, din: V3) -> Frame:
    return soa.flip(frame, soa.dot(frame.n, din) * soa.dot(gn, din) < 0.0)


def _c_tint(base: V3) -> V3:
    lum = soa.luminance(base)
    ones = torch.ones_like(lum)
    inv = torch.where(lum > 0, 1.0 / torch.where(lum > 0, lum, 1.0), 1.0)
    return soa.where(lum > 0, base * inv, V3(ones, ones, ones))


def _ones3(like):
    one = torch.ones_like(like)
    return V3(one, one, one)


# ---------------------------------------------------------------------------
# Per-kind eval / pdf / sample (reference: gdpt_tpu/ops/materials_soa.py:332-714)
# ---------------------------------------------------------------------------


def eval_lambertian(p, din, dout, gn, frame0):
    frame = _refl_frame(frame0, din)
    ok = (soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0)
    val = torch.where(ok, torch.clamp_min(soa.dot(frame.n, dout), 0.0) / math.pi, 0.0)
    return p.refl * val


def pdf_lambertian(p, din, dout, gn, frame0):
    frame = _refl_frame(frame0, din)
    ok = (soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0)
    return torch.where(ok, torch.clamp_min(soa.dot(frame.n, dout), 0.0) / math.pi, 0.0)


def sample_lambertian(p, din, gn, frame0, u0, u1, w):
    frame = _refl_frame(frame0, din)
    d = _cos_hemisphere(frame, u0, u1)
    ok = (soa.dot(gn, din) >= 0).to(REAL)
    return BSDFSampleSoA(d, torch.zeros_like(ok), torch.ones_like(ok), ok)


def eval_rough_plastic(p, din, dout, gn, frame0):
    frame = _refl_frame(frame0, din)
    half = soa.normalize(din + dout)
    n_h = soa.dot(frame.n, half)
    n_in = soa.dot(frame.n, din)
    n_out = soa.dot(frame.n, dout)
    ok = (soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0) & (n_out > 0) & (n_h > 0)
    rough = _clamp_rough(p.roughness)
    f_o = _fresnel_dielectric(soa.dot(half, dout), p.eta)
    d = _gtr2(n_h, rough)
    g = _smith_g1(soa.to_local(frame, din), rough) * _smith_g1(
        soa.to_local(frame, dout), rough)
    spec_scale = _safe_div(g * f_o * d, 4.0 * n_in * n_out)
    f_i = _fresnel_dielectric(soa.dot(half, din), p.eta)
    diff_scale = (1.0 - f_o) * (1.0 - f_i) / math.pi
    mask = torch.where(ok, n_out, 0.0)
    return (p.spec_refl * spec_scale + p.refl * diff_scale) * mask


def pdf_rough_plastic(p, din, dout, gn, frame0):
    frame = _refl_frame(frame0, din)
    half = soa.normalize(din + dout)
    n_h = soa.dot(frame.n, half)
    n_in = soa.dot(frame.n, din)
    n_out = soa.dot(frame.n, dout)
    l_s = soa.luminance(p.spec_refl)
    l_r = soa.luminance(p.refl)
    ok = ((soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0)
          & (n_out > 0) & (n_h > 0) & (l_s + l_r > 0))
    rough = _clamp_rough(p.roughness)
    spec_prob = _safe_div(l_s, l_s + l_r) * _safe_div(
        _smith_g1(soa.to_local(frame, din), rough) * _gtr2(n_h, rough), 4.0 * n_in)
    diff_prob = _safe_div(l_r, l_s + l_r) * torch.clamp_min(n_out, 0.0) / math.pi
    return torch.where(ok, spec_prob + diff_prob, 0.0)


def sample_rough_plastic(p, din, gn, frame0, u0, u1, w):
    frame = _refl_frame(frame0, din)
    l_s = soa.luminance(p.spec_refl)
    l_r = soa.luminance(p.refl)
    ok = (soa.dot(gn, din) >= 0) & (l_s + l_r > 0)
    spec_prob = _safe_div(l_s, l_s + l_r)
    rough = _clamp_rough(p.roughness)
    local_in = soa.to_local(frame, din)
    alpha = rough * rough
    half = soa.to_world(frame, _vndf_sample(local_in, alpha, alpha, u0, u1))
    refl = _reflect_over(din, half)
    diff = _cos_hemisphere(frame, u0, u1)
    take_spec = w < spec_prob
    d = soa.where(take_spec, refl, diff)
    roughness = torch.where(take_spec, rough, 1.0)
    return BSDFSampleSoA(d, torch.zeros_like(rough), roughness, ok.to(REAL))


def _dielectric_common(p, din, dout, gn, frame0):
    reflect = soa.dot(gn, din) * soa.dot(gn, dout) > 0
    frame = _trans_frame(frame0, gn, din)
    eta = torch.where(soa.dot(gn, din) > 0, p.eta, 1.0 / p.eta)
    half = soa.where(reflect, soa.normalize(din + dout), soa.normalize(din + dout * eta))
    half = soa.where(soa.dot(half, frame.n) < 0, -half, half)
    return reflect, frame, eta, half


def eval_rough_dielectric(p, din, dout, gn, frame0, base_refl=None,
                          base_trans=None, aniso=None):
    """base_refl / base_trans: the reflection and transmission colours
    (rough dielectric: spec_refl, spec_trans); with base_trans None the
    Disney-glass form (sqrt of refl, its own radiance factor). aniso:
    Disney's anisotropic alphas, else isotropic."""
    reflect, frame, eta, half = _dielectric_common(p, din, dout, gn, frame0)
    rough = _clamp_rough(p.roughness)
    h_in = soa.dot(half, din)
    f = _fresnel_dielectric(h_in, eta)
    if aniso is not None:
        ax, ay = _aniso_alphas(rough, aniso)
        d = _gtr2_aniso(soa.to_local(frame, half), ax, ay)
        g = _smith_g1_aniso(soa.to_local(frame, din), ax, ay) * _smith_g1_aniso(
            soa.to_local(frame, dout), ax, ay)
    else:
        d = _gtr2(soa.dot(frame.n, half), rough)
        g = _smith_g1(soa.to_local(frame, din), rough) * _smith_g1(
            soa.to_local(frame, dout), rough)
    n_in = torch.abs(soa.dot(frame.n, din))
    refl_scale = _safe_div(f * d * g, 4.0 * n_in)
    h_out = soa.dot(half, dout)
    sqrt_denom = h_in + eta * h_out
    if base_trans is None:
        trans_scale = _safe_div((1.0 - f) * d * g * torch.abs(h_out * h_in),
                                n_in * sqrt_denom * sqrt_denom)
    else:
        eta_factor = 1.0 / (eta * eta)
        trans_scale = _safe_div(
            eta_factor * (1.0 - f) * d * g * eta * eta * torch.abs(h_out * h_in),
            n_in * sqrt_denom * sqrt_denom)
    krefl = base_refl if base_refl is not None else p.spec_refl
    if base_trans is not None:
        ktrans = base_trans
    else:
        ktrans = V3(*(torch.sqrt(torch.clamp_min(c, 0.0)) for c in p.refl))
    return soa.where(reflect, krefl * refl_scale, ktrans * trans_scale)


def pdf_rough_dielectric(p, din, dout, gn, frame0, aniso=None):
    reflect, frame, eta, half = _dielectric_common(p, din, dout, gn, frame0)
    rough = _clamp_rough(p.roughness)
    h_in = soa.dot(half, din)
    f = _fresnel_dielectric(h_in, eta)
    if aniso is not None:
        ax, ay = _aniso_alphas(rough, aniso)
        d = _gtr2_aniso(soa.to_local(frame, half), ax, ay)
        g_in = _smith_g1_aniso(soa.to_local(frame, din), ax, ay)
    else:
        d = _gtr2(soa.dot(half, frame.n), rough)
        g_in = _smith_g1(soa.to_local(frame, din), rough)
    n_in = soa.dot(frame.n, din)
    refl_pdf = _safe_div(f * d * g_in, 4.0 * torch.abs(n_in))
    h_out = soa.dot(half, dout)
    sqrt_denom = h_in + eta * h_out
    dh_dout = _safe_div(eta * eta * h_out, sqrt_denom * sqrt_denom)
    trans_pdf = (1.0 - f) * d * g_in * torch.abs(_safe_div(dh_dout * h_in, n_in))
    return torch.where(reflect, refl_pdf, trans_pdf)


def sample_rough_dielectric(p, din, gn, frame0, u0, u1, w, aniso=None):
    frame = _trans_frame(frame0, gn, din)
    eta = torch.where(soa.dot(gn, din) > 0, p.eta, 1.0 / p.eta)
    rough = _clamp_rough(p.roughness)
    local_in = soa.to_local(frame, din)
    if aniso is not None:
        ax, ay = _aniso_alphas(rough, aniso)
    else:
        ax = ay = rough * rough
    half = soa.to_world(frame, _vndf_sample(local_in, ax, ay, u0, u1))
    half = soa.where(soa.dot(half, frame.n) < 0, -half, half)
    h_in = soa.dot(half, din)
    f = _fresnel_dielectric(h_in, eta)
    reflected = _reflect_over(din, half)
    h_out_sq = 1.0 - (1.0 - h_in * h_in) / (eta * eta)
    half_t = soa.where(h_in < 0, -half, half)
    h_out = torch.sqrt(torch.clamp_min(h_out_sq, 0.0))
    refracted = soa.normalize(-din * (1.0 / eta) + half_t * (torch.abs(h_in) / eta - h_out))
    take_refl = w <= f
    d = soa.where(take_refl, reflected, refracted)
    out_eta = torch.where(take_refl, 0.0, eta)
    valid = (take_refl | (h_out_sq > 0)).to(REAL)
    return BSDFSampleSoA(d, out_eta, rough, valid)


def eval_disney_diffuse(p, din, dout, gn, frame0):
    frame = _refl_frame(frame0, din)
    ok = (soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0)
    half = soa.normalize(din + dout)
    n_in = torch.abs(soa.dot(frame.n, din))
    n_out = torch.abs(soa.dot(frame.n, dout))
    h_out = torch.abs(soa.dot(half, dout))
    rough = _clamp_rough(p.roughness)
    fd90 = 0.5 + 2.0 * rough * h_out * h_out
    p5o = _pow5(1.0 - n_out)
    p5i = _pow5(1.0 - n_in)
    base_scale = (1.0 + (fd90 - 1.0) * p5o) * (1.0 + (fd90 - 1.0) * p5i) * n_out / math.pi
    fss90 = rough * h_out * h_out
    ss_scale = (
        1.25 / math.pi
        * ((1.0 + (fss90 - 1.0) * p5i) * (1.0 + (fss90 - 1.0) * p5o)
           * (_safe_div(1.0, n_in + n_out) - 0.5) + 0.5)
        * n_out
    )
    scale = (1.0 - p.subsurface) * base_scale + p.subsurface * ss_scale
    return p.refl * torch.where(ok, scale, 0.0)


def eval_disney_metal(p, din, dout, gn, frame0, base=None):
    frame = _refl_frame(frame0, din)
    ok = (soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0)
    col = base if base is not None else p.refl
    half = soa.normalize(din + dout)
    n_in = torch.abs(soa.dot(frame.n, din))
    h_out = torch.abs(soa.dot(half, dout))
    rough = _clamp_rough(p.roughness)
    ax, ay = _aniso_alphas(rough, p.anisotropic)
    f_m = col + (_ones3(h_out) - col) * _pow5(1.0 - h_out)
    d = _gtr2_aniso(soa.to_local(frame, half), ax, ay)
    g = _smith_g1_aniso(soa.to_local(frame, din), ax, ay) * _smith_g1_aniso(
        soa.to_local(frame, dout), ax, ay)
    return f_m * torch.where(ok, _safe_div(d * g, 4.0 * n_in), 0.0)


def pdf_disney_metal(p, din, dout, gn, frame0):
    frame = _refl_frame(frame0, din)
    ok = (soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0)
    half = soa.normalize(din + dout)
    rough = _clamp_rough(p.roughness)
    ax, ay = _aniso_alphas(rough, p.anisotropic)
    d = _gtr2_aniso(soa.to_local(frame, half), ax, ay)
    g_in = _smith_g1_aniso(soa.to_local(frame, din), ax, ay)
    n_in = torch.abs(soa.dot(frame.n, din))
    return torch.where(ok, _safe_div(g_in * d, 4.0 * n_in), 0.0)


def sample_disney_metal(p, din, gn, frame0, u0, u1, w):
    frame = _refl_frame(frame0, din)
    rough = _clamp_rough(p.roughness)
    ax, ay = _aniso_alphas(rough, p.anisotropic)
    local_in = soa.to_local(frame, din)
    half = soa.to_world(frame, _vndf_sample(local_in, ax, ay, u0, u1))
    d = _reflect_over(din, half)
    ok = (soa.dot(gn, din) >= 0).to(REAL)
    return BSDFSampleSoA(d, torch.zeros_like(rough), rough, ok)


def _clearcoat_alpha(gloss):
    return (1.0 - gloss) * 0.1 + gloss * 0.001


def _gtr1(hz, alpha):
    a2 = alpha * alpha
    denom = math.pi * torch.log(a2) * (1.0 + (a2 - 1.0) * hz * hz)
    denom = torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)
    return (a2 - 1.0) / denom


def eval_disney_clearcoat(p, din, dout, gn, frame0):
    frame = _refl_frame(frame0, din)
    ok = (soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0)
    half = soa.normalize(din + dout)
    h_out = torch.abs(soa.dot(half, dout))
    f_c = 0.04 + 0.96 * _pow5(1.0 - h_out)
    alpha = _clearcoat_alpha(p.clearcoat_gloss)
    d_c = _gtr1(soa.to_local(frame, half).z, alpha)
    g_c = _smith_g1_aniso(soa.to_local(frame, din), 0.25, 0.25) * _smith_g1_aniso(
        soa.to_local(frame, dout), 0.25, 0.25)
    n_in = torch.abs(soa.dot(frame.n, din))
    scale = torch.where(ok, _safe_div(f_c * d_c * g_c, 4.0 * n_in), 0.0)
    return V3(scale, scale, scale)


def pdf_disney_clearcoat(p, din, dout, gn, frame0):
    frame = _refl_frame(frame0, din)
    ok = (soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0)
    half = soa.normalize(din + dout)
    alpha = _clearcoat_alpha(p.clearcoat_gloss)
    d_c = _gtr1(soa.to_local(frame, half).z, alpha)
    n_h = torch.abs(soa.dot(frame.n, half))
    h_out = torch.abs(soa.dot(half, dout))
    return torch.where(ok, _safe_div(d_c * n_h, 4.0 * h_out), 0.0)


def sample_disney_clearcoat(p, din, gn, frame0, u0, u1, w):
    frame = _refl_frame(frame0, din)
    alpha = _clearcoat_alpha(p.clearcoat_gloss)
    a2 = alpha * alpha
    azim = 2.0 * math.pi * u1
    cos2 = (1.0 - torch.pow(a2, 1.0 - u0)) / (1.0 - a2)
    cos_e = torch.sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_e = torch.sqrt(torch.clamp(1.0 - cos2, 0.0, 1.0))
    half = soa.to_world(
        frame, soa.normalize(V3(sin_e * torch.cos(azim), sin_e * torch.sin(azim), cos_e)))
    d = _reflect_over(din, half)
    ok = (soa.dot(gn, din) >= 0).to(REAL)
    return BSDFSampleSoA(d, torch.zeros_like(alpha), alpha, ok)


def eval_disney_sheen(p, din, dout, gn, frame0):
    frame = _refl_frame(frame0, din)
    ok = (soa.dot(gn, din) >= 0) & (soa.dot(gn, dout) >= 0)
    half = soa.normalize(din + dout)
    h_out = torch.abs(soa.dot(half, dout))
    n_out = torch.abs(soa.dot(frame.n, dout))
    c_sheen = _ones3(h_out) * (1.0 - p.sheen_tint) + _c_tint(p.refl) * p.sheen_tint
    return c_sheen * torch.where(ok, _pow5(1.0 - h_out) * n_out, 0.0)


def _disney_weights(p):
    dw = (1.0 - p.specular_transmission) * (1.0 - p.metallic)
    mw = 1.0 - p.specular_transmission * (1.0 - p.metallic)
    cw = 0.25 * p.clearcoat
    gw = (1.0 - p.metallic) * p.specular_transmission
    return dw, mw, cw, gw


def _disney_metal_color(p, gn, din):
    eta = torch.where(soa.dot(gn, din) > 0, p.eta, 1.0 / p.eta)
    ks = _ones3(eta) * (1.0 - p.specular_tint) + _c_tint(p.refl) * p.specular_tint
    r0 = ((eta - 1.0) / (eta + 1.0)) ** 2
    return ks * (p.specular * r0 * (1.0 - p.metallic)) + p.refl * p.metallic


def eval_disney_bsdf(p, din, dout, gn, frame0):
    below = soa.dot(gn, din) <= 0
    dw, mw, cw, gw = _disney_weights(p)
    sheen_w = (1.0 - p.metallic) * p.sheen
    glass = eval_rough_dielectric(p, din, dout, gn, frame0, base_refl=p.refl,
                                  aniso=p.anisotropic)
    diffuse = eval_disney_diffuse(p, din, dout, gn, frame0)
    metal = eval_disney_metal(p, din, dout, gn, frame0, base=_disney_metal_color(p, gn, din))
    cc = eval_disney_clearcoat(p, din, dout, gn, frame0)
    sheen = eval_disney_sheen(p, din, dout, gn, frame0)
    full = diffuse * dw + metal * mw + cc * cw + glass * gw + sheen * sheen_w
    return soa.where(below, glass * gw, full)


def pdf_disney_bsdf(p, din, dout, gn, frame0):
    below = soa.dot(gn, din) <= 0
    dw, mw, cw, gw = _disney_weights(p)
    total = torch.clamp_min(dw + mw + cw + gw, 1e-20)
    glass_pdf = pdf_rough_dielectric(p, din, dout, gn, frame0, aniso=p.anisotropic)
    mix = (
        dw * pdf_lambertian(p, din, dout, gn, frame0)
        + mw * pdf_disney_metal(p, din, dout, gn, frame0)
        + cw * pdf_disney_clearcoat(p, din, dout, gn, frame0)
        + gw * glass_pdf
    ) / total
    return torch.where(below, glass_pdf, mix)


def _pick(cond, a: BSDFSampleSoA, b: BSDFSampleSoA) -> BSDFSampleSoA:
    return BSDFSampleSoA(
        soa.where(cond, a.dir_out, b.dir_out),
        torch.where(cond, a.eta, b.eta),
        torch.where(cond, a.roughness, b.roughness),
        torch.where(cond, a.valid, b.valid),
    )


def sample_disney_bsdf(p, din, gn, frame0, u0, u1, w):
    below = soa.dot(gn, din) <= 0
    dw, mw, cw, gw = _disney_weights(p)
    total = torch.clamp_min(dw + mw + cw + gw, 1e-20)
    c1 = dw / total
    c2 = c1 + mw / total
    c3 = c2 + cw / total
    w_glass = torch.clamp(_safe_div(w - c3, 1.0 - c3), 0.0, 1.0)
    s_diff = sample_lambertian(p, din, gn, frame0, u0, u1, w)
    s_diff = s_diff._replace(roughness=_clamp_rough(p.roughness))
    s_metal = sample_disney_metal(p, din, gn, frame0, u0, u1, w)
    s_cc = sample_disney_clearcoat(p, din, gn, frame0, u0, u1, w)
    s_glass = sample_rough_dielectric(p, din, gn, frame0, u0, u1,
                                      torch.where(below, w, w_glass), aniso=p.anisotropic)
    out = _pick(w < c1, s_diff, _pick(w < c2, s_metal, _pick(w < c3, s_cc, s_glass)))
    return _pick(below, s_glass, out)


# ---------------------------------------------------------------------------
# Dispatch: every used kind is evaluated for every lane, then selected
# ---------------------------------------------------------------------------


def eval_bsdf_soa(p: MatParamsSoA, din, dout, gn, frame, used_kinds) -> V3:
    out = V3(*(torch.zeros_like(p.eta),) * 3)
    table = {
        M.MAT_LAMBERTIAN: lambda: eval_lambertian(p, din, dout, gn, frame),
        M.MAT_ROUGH_PLASTIC: lambda: eval_rough_plastic(p, din, dout, gn, frame),
        M.MAT_ROUGH_DIELECTRIC: lambda: eval_rough_dielectric(
            p, din, dout, gn, frame, base_refl=p.spec_refl, base_trans=p.spec_trans),
        M.MAT_DISNEY_DIFFUSE: lambda: eval_disney_diffuse(p, din, dout, gn, frame),
        M.MAT_DISNEY_METAL: lambda: eval_disney_metal(p, din, dout, gn, frame),
        M.MAT_DISNEY_GLASS: lambda: eval_rough_dielectric(
            p, din, dout, gn, frame, base_refl=p.refl, aniso=p.anisotropic),
        M.MAT_DISNEY_CLEARCOAT: lambda: eval_disney_clearcoat(p, din, dout, gn, frame),
        M.MAT_DISNEY_SHEEN: lambda: eval_disney_sheen(p, din, dout, gn, frame),
        M.MAT_DISNEY_BSDF: lambda: eval_disney_bsdf(p, din, dout, gn, frame),
    }
    for k in used_kinds:
        out = soa.where(p.kind == k, table[k](), out)
    return out


def pdf_bsdf_soa(p: MatParamsSoA, din, dout, gn, frame, used_kinds):
    out = torch.zeros_like(p.eta)
    table = {
        M.MAT_LAMBERTIAN: lambda: pdf_lambertian(p, din, dout, gn, frame),
        M.MAT_ROUGH_PLASTIC: lambda: pdf_rough_plastic(p, din, dout, gn, frame),
        M.MAT_ROUGH_DIELECTRIC: lambda: pdf_rough_dielectric(p, din, dout, gn, frame),
        M.MAT_DISNEY_DIFFUSE: lambda: pdf_lambertian(p, din, dout, gn, frame),
        M.MAT_DISNEY_METAL: lambda: pdf_disney_metal(p, din, dout, gn, frame),
        M.MAT_DISNEY_GLASS: lambda: pdf_rough_dielectric(
            p, din, dout, gn, frame, aniso=p.anisotropic),
        M.MAT_DISNEY_CLEARCOAT: lambda: pdf_disney_clearcoat(p, din, dout, gn, frame),
        M.MAT_DISNEY_SHEEN: lambda: pdf_lambertian(p, din, dout, gn, frame),
        M.MAT_DISNEY_BSDF: lambda: pdf_disney_bsdf(p, din, dout, gn, frame),
    }
    for k in used_kinds:
        out = torch.where(p.kind == k, table[k](), out)
    return out


def sample_bsdf_soa(p: MatParamsSoA, din, gn, frame, u0, u1, w, used_kinds):
    zero = torch.zeros_like(p.eta)
    out = BSDFSampleSoA(V3(zero, zero, zero + 1.0), zero, zero + 1.0, zero)
    table = {
        M.MAT_LAMBERTIAN: lambda: sample_lambertian(p, din, gn, frame, u0, u1, w),
        M.MAT_ROUGH_PLASTIC: lambda: sample_rough_plastic(p, din, gn, frame, u0, u1, w),
        M.MAT_ROUGH_DIELECTRIC: lambda: sample_rough_dielectric(p, din, gn, frame, u0, u1, w),
        M.MAT_DISNEY_DIFFUSE: lambda: sample_lambertian(p, din, gn, frame, u0, u1, w)._replace(
            roughness=_clamp_rough(p.roughness)),
        M.MAT_DISNEY_METAL: lambda: sample_disney_metal(p, din, gn, frame, u0, u1, w),
        M.MAT_DISNEY_GLASS: lambda: sample_rough_dielectric(
            p, din, gn, frame, u0, u1, w, aniso=p.anisotropic),
        M.MAT_DISNEY_CLEARCOAT: lambda: sample_disney_clearcoat(p, din, gn, frame, u0, u1, w),
        M.MAT_DISNEY_SHEEN: lambda: sample_lambertian(p, din, gn, frame, u0, u1, w),
        M.MAT_DISNEY_BSDF: lambda: sample_disney_bsdf(p, din, gn, frame, u0, u1, w),
    }
    for k in used_kinds:
        out = _pick(p.kind == k, table[k](), out)
    return out
