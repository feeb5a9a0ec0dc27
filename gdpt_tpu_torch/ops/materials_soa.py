"""Batched (SoA) material stack.

Counterpart of gdpt_tpu/ops/materials_soa.py, with the same conventions:
eval returns BSDF * |cos|, pdf is in solid angle, sample returns
(dir, eta, roughness, valid-mask f32). Ported so far: the Lambertian
BSDF, constant and checkerboard texture slots. The dispatchers raise
NotImplementedError for a material kind or an image slot a scene uses
that is not ported yet (see ROADMAP.md).
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


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md")


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


def _checker_sign(lu, lv):
    """cx * cy of the reference's checkerboard (src/texture.h:141-152)."""
    cx = 2 * torch.remainder((lu * 2).to(INT), 2) - 1
    cy = 2 * torch.remainder((lv * 2).to(INT), 2) - 1
    return cx * cy


def _eval_spec_slot(tables: MaterialTablesSoA, slot, mid, uv_u, uv_v,
                    img_used: bool) -> V3:
    if img_used:
        raise _not_ported(f"image texture in spectrum slot {slot!r}")
    i = _SPEC_SLOTS.index(slot)
    kind = soa.take(tables.spec_kind[i], mid)
    c0 = soa.gather(tables.spec_c0[i], mid)
    c1 = soa.gather(tables.spec_c1[i], mid)
    us, vs, uo, vo = tables.spec_uv[i]
    lu = torch.remainder(uv_u * soa.take(us, mid) + soa.take(uo, mid), 1.0)
    lv = torch.remainder(uv_v * soa.take(vs, mid) + soa.take(vo, mid), 1.0)
    checker = soa.where(_checker_sign(lu, lv) == 1, c0, c1)
    return soa.where(kind == tex.TEX_CHECKER, checker, c0)


def _eval_float_slot(tables: MaterialTablesSoA, i, mid, uv_u, uv_v,
                     slot_mode: int):
    """slot_mode: OR of 1 (any checker) | 2 (any image) over the scene."""
    if slot_mode & 2:
        raise _not_ported(f"image texture in float slot {_FLOAT_SLOTS[i]!r}")
    c0 = soa.take(tables.float_const[i], mid)
    if not slot_mode:
        return c0
    kind = soa.take(tables.float_kind[i], mid)
    us, vs, uo, vo = tables.float_uv[i]
    lu = torch.remainder(uv_u * soa.take(us, mid) + soa.take(uo, mid), 1.0)
    lv = torch.remainder(uv_v * soa.take(vs, mid) + soa.take(vo, mid), 1.0)
    c1 = soa.take(tables.float_c1[i], mid)
    checker = torch.where(_checker_sign(lu, lv) == 1, c0, c1)
    return torch.where(kind == tex.TEX_CHECKER, checker, c0)


def gather_params_soa(tables: MaterialTablesSoA, used_kinds, material_id,
                      uv_u, uv_v, spec_image_slots=(False, False, False),
                      float_tex_slots=None) -> MatParamsSoA:
    mid = torch.clamp_min(material_id, 0)
    used = set(used_kinds)
    zero = torch.zeros(mid.shape[0], dtype=REAL, device=mid.device)
    zero3 = V3(zero, zero, zero)

    def spec(slot):
        if used & _SLOT_USERS[slot]:
            return _eval_spec_slot(tables, slot, mid, uv_u, uv_v,
                                   spec_image_slots[_SPEC_SLOTS.index(slot)])
        return zero3

    def flt(slot):
        if used & _SLOT_USERS[slot]:
            i = _FLOAT_SLOTS.index(slot)
            mode = float_tex_slots[i] if float_tex_slots else 0
            return _eval_float_slot(tables, i, mid, uv_u, uv_v, mode)
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


def _cos_hemisphere(frame: Frame, u0, u1) -> V3:
    phi = 2.0 * math.pi * u0
    r = torch.sqrt(u1)
    return soa.to_world(
        frame, V3(r * torch.cos(phi), r * torch.sin(phi),
                  torch.sqrt(torch.clamp(1.0 - u1, 0.0, 1.0)))
    )


def _refl_frame(frame: Frame, din: V3) -> Frame:
    return soa.flip(frame, soa.dot(frame.n, din) < 0.0)


# ---------------------------------------------------------------------------
# Per-kind eval / pdf / sample
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


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _entry(table, k):
    if k not in table:
        raise _not_ported(f"material kind {k} (scene.model.MAT_*)")
    return table[k]


def eval_bsdf_soa(p: MatParamsSoA, din, dout, gn, frame, used_kinds) -> V3:
    out = V3(*(torch.zeros_like(p.eta),) * 3)
    table = {M.MAT_LAMBERTIAN: lambda: eval_lambertian(p, din, dout, gn, frame)}
    for k in used_kinds:
        out = soa.where(p.kind == k, _entry(table, k)(), out)
    return out


def pdf_bsdf_soa(p: MatParamsSoA, din, dout, gn, frame, used_kinds):
    out = torch.zeros_like(p.eta)
    table = {M.MAT_LAMBERTIAN: lambda: pdf_lambertian(p, din, dout, gn, frame)}
    for k in used_kinds:
        out = torch.where(p.kind == k, _entry(table, k)(), out)
    return out


def sample_bsdf_soa(p: MatParamsSoA, din, gn, frame, u0, u1, w, used_kinds):
    zero = torch.zeros_like(p.eta)
    out = BSDFSampleSoA(V3(zero, zero, zero + 1.0), zero, zero + 1.0, zero)
    table = {M.MAT_LAMBERTIAN: lambda: sample_lambertian(p, din, gn, frame, u0, u1, w)}
    for k in used_kinds:
        s = _entry(table, k)()
        sel = p.kind == k
        out = BSDFSampleSoA(
            soa.where(sel, s.dir_out, out.dir_out),
            torch.where(sel, s.eta, out.eta),
            torch.where(sel, s.roughness, out.roughness),
            torch.where(sel, s.valid, out.valid),
        )
    return out
