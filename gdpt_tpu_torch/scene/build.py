"""Freeze a host scene description into flat tensors.

Counterpart of gdpt_tpu/scene/build.py (reference: src/scene.cpp:4-53):
the same DeviceScene and SceneStatic fields, built on the host in numpy
and held as CPU tensors; ``scene_to`` carries a scene to a device, as
model weights are carried. Scenes above BRUTE_FORCE_THRESHOLD primitives
(or built with force_bvh) get a host BVH (accel/bvh.py) in the
Geometry.bvh_* fields; the packet table over it is made per render, on
the scene's device (accel/traverse_soa.geom_soa_from_aos).
"""

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gdpt_tpu_torch.accel import bvh as gbvh
from gdpt_tpu_torch.core import spectrum as gspec
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.distributions import TableDist1D, TableDist2D, make_table_dist_1d, make_table_dist_2d
from gdpt_tpu_torch.core.dtypes import INT, REAL, asarray
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene import textures as tex
from gdpt_tpu_torch.scene.camera import CameraArrays, make_camera_arrays

SHAPE_MESH = 0
SHAPE_SPHERE = 1

LIGHT_AREA = 0
LIGHT_ENVMAP = 1

# Scenes of at most this many primitives are ray cast by brute force
# (gdpt_tpu/accel/traverse.py:292).
BRUTE_FORCE_THRESHOLD = 128


def use_brute_force(n_prims: int) -> bool:
    return n_prims <= BRUTE_FORCE_THRESHOLD


class Geometry(NamedTuple):
    """Flattened scene geometry (gdpt_tpu/accel/traverse.py:25). The BVH
    fields (accel/bvh.BVHArrays) stay empty in the brute-force regime."""

    tri_v0: torch.Tensor       # (T, 3)
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_shape_id: torch.Tensor  # (T,)
    sph_center: torch.Tensor    # (S, 3)
    sph_radius: torch.Tensor    # (S,)
    sph_shape_id: torch.Tensor  # (S,)
    bvh_bbox_min: torch.Tensor
    bvh_bbox_max: torch.Tensor
    bvh_first: torch.Tensor
    bvh_count: torch.Tensor
    bvh_miss: torch.Tensor
    bvh_prim_order: torch.Tensor


class MaterialTable(NamedTuple):
    kind: torch.Tensor  # (m,)
    eta: torch.Tensor   # (m,)
    # Spectrum slots (TexDesc with C=3)
    refl: tex.TexDesc         # reflectance / diffuse_reflectance / base_color
    spec_refl: tex.TexDesc    # specular_reflectance
    spec_trans: tex.TexDesc   # specular_transmittance
    # Float slots (TexDesc with C=1)
    roughness: tex.TexDesc
    anisotropic: tex.TexDesc
    subsurface: tex.TexDesc
    metallic: tex.TexDesc
    specular: tex.TexDesc
    specular_tint: tex.TexDesc
    sheen: tex.TexDesc
    sheen_tint: tex.TexDesc
    clearcoat: tex.TexDesc
    clearcoat_gloss: tex.TexDesc
    specular_transmission: tex.TexDesc


class LightArrays(NamedTuple):
    kind: torch.Tensor       # (l,)
    shape_id: torch.Tensor   # (l,)
    intensity: torch.Tensor  # (l, 3)
    # Triangle-area CDF per mesh light, padded to the max triangle count.
    tri_cdf: torch.Tensor    # (l, max_tris + 1)
    tri_first: torch.Tensor  # (l,) first global triangle id of the mesh
    pmf: torch.Tensor        # (l,) light selection pmf (power-weighted)
    cdf: torch.Tensor        # (l + 1,)


class EnvmapArrays(NamedTuple):
    to_world: torch.Tensor   # (4, 4)
    to_local: torch.Tensor   # (4, 4)
    scale: torch.Tensor      # ()
    tex: tex.TexDesc         # single-row spectrum descriptor
    dist: TableDist2D


class VolumeArrays(NamedTuple):
    value: torch.Tensor     # (3,) constant value
    grid: torch.Tensor      # (zres, yres, xres, 3); (1,1,1,3) when constant
    p_min: torch.Tensor     # (3,)
    p_max: torch.Tensor     # (3,)
    max_data: torch.Tensor  # (3,)
    scale: torch.Tensor     # ()


class MediumArrays(NamedTuple):
    sigma_a: torch.Tensor  # (3,) homogeneous
    sigma_s: torch.Tensor  # (3,)
    albedo: VolumeArrays
    density: VolumeArrays
    phase_g: torch.Tensor  # ()


class DeviceScene(NamedTuple):
    geom: Geometry
    camera: CameraArrays
    # Per-shape tables (s,)
    shape_kind: torch.Tensor
    shape_material_id: torch.Tensor
    shape_light_id: torch.Tensor
    shape_interior_medium: torch.Tensor
    shape_exterior_medium: torch.Tensor
    shape_area: torch.Tensor         # total surface area
    shape_prim_offset: torch.Tensor  # mesh: first global tri; sphere: index
    # Global mesh vertex data
    vtx_pos: torch.Tensor     # (v, 3)
    vtx_normal: torch.Tensor  # (v, 3)
    vtx_uv: torch.Tensor      # (v, 2)
    tri_index: torch.Tensor   # (t, 3)
    tri_has_normals: torch.Tensor  # (t,) bool
    tri_has_uvs: torch.Tensor      # (t,) bool
    materials: MaterialTable
    pool3: tex.TexturePoolArrays
    pool1: tex.TexturePoolArrays
    lights: LightArrays
    envmap: EnvmapArrays
    media: Tuple[MediumArrays, ...]


@dataclass(frozen=True)
class SceneStatic:
    """Hashable scene facts that select code paths."""

    width: int
    height: int
    n_tris: int
    n_spheres: int
    n_shapes: int
    n_lights: int
    n_materials: int
    use_brute_force: bool
    used_material_kinds: Tuple[int, ...]
    has_envmap: bool
    envmap_light_id: int
    envmap_is_image: bool
    spec_image_slots: tuple  # per (refl, spec_refl, spec_trans): any image tex
    float_tex_slots: tuple   # per float slot: 1 = any checker, 2 = any image
    filter_kind: int
    filter_param: float
    camera_medium_id: int
    media_phase_kinds: Tuple[int, ...]
    media_is_hetero: Tuple[bool, ...]
    media_albedo_is_grid: Tuple[bool, ...]
    media_grid_res: Tuple
    shadow_epsilon: float
    intersection_epsilon: float
    options: M.RenderOptions
    any_mesh_light: bool
    any_sphere_light: bool
    any_mesh_normals: bool
    any_mesh_uvs: bool


class Scene(NamedTuple):
    device: DeviceScene
    static: SceneStatic
    # Which BVH builder made Geometry.bvh_* ("native" or "numpy"; "" for
    # brute-force scenes and scenes carried over by convert.py). A
    # record, not a switch.
    bvh_builder: str = ""


class SceneMemo:
    """What was last derived from a few scenes, keyed by the identity of
    the scene's tensor tree (and a hashable extra). Repeated renders of
    one scene then reuse the copy on the card and its packet table, which
    cost seconds of host work on a large scene. The entry holds the tree,
    so its id stays valid; a few entries, the least recently used one
    dropped first, as a process touches a handful of scenes."""

    def __init__(self, cap=4):
        self.cap = cap
        self.entries = {}

    def get(self, tree, extra, make):
        key = (id(tree), extra)
        hit = self.entries.get(key)
        if hit is not None and hit[0] is tree:
            self.entries[key] = self.entries.pop(key)  # now the most recent
            return hit[1]
        out = make()
        if len(self.entries) >= self.cap:
            self.entries.pop(next(iter(self.entries)))
        self.entries[key] = (tree, out)
        return out


_MOVED = SceneMemo()


def scene_to(scene: Scene, device) -> Scene:
    """The same scene with every tensor on `device` (the tensor tree is
    memoised per scene and device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dev = _MOVED.get(scene.device, device,
                     lambda: soa.tree_map(lambda t: t.to(device), scene.device))
    return scene._replace(device=dev)


# ---------------------------------------------------------------------------
# Texture packing
# ---------------------------------------------------------------------------


class _PoolBuilder:
    def __init__(self):
        self.images3, self.images1 = [], []
        self.cache3, self.cache1 = {}, {}

    def add3(self, data, name):
        key = name or id(data)
        if key in self.cache3:
            return self.cache3[key]
        idx = len(self.images3)
        arr = np.asarray(data, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None].repeat(3, axis=-1)
        self.images3.append(arr[..., :3])
        self.cache3[key] = idx
        return idx

    def add1(self, data, name):
        key = name or id(data)
        if key in self.cache1:
            return self.cache1[key]
        idx = len(self.images1)
        arr = np.asarray(data, np.float32)
        if arr.ndim == 3:
            arr = arr.mean(axis=-1)
        self.images1.append(arr[..., None])
        self.cache1[key] = idx
        return idx


def _tex_to_desc(t, channels, pools: _PoolBuilder):
    """Host texture -> descriptor dict for textures.make_tex_desc."""
    def cval(v):
        v = np.asarray(v, np.float64).reshape(-1)
        if channels == 3 and v.size == 1:
            v = np.repeat(v, 3)
        if channels == 1 and v.size > 1:
            v = v[:1]
        return v

    if isinstance(t, M.ConstantTexture):
        return {"kind": tex.TEX_CONST, "value": cval(t.value)}
    if isinstance(t, M.ImageTexture):
        img_id = pools.add3(t.data, t.name) if channels == 3 else pools.add1(t.data, t.name)
        return {
            "kind": tex.TEX_IMAGE, "img_id": img_id,
            "uscale": t.uscale, "vscale": t.vscale,
            "uoffset": t.uoffset, "voffset": t.voffset,
        }
    if isinstance(t, M.CheckerboardTexture):
        return {
            "kind": tex.TEX_CHECKER,
            "value": cval(t.color0), "value2": cval(t.color1),
            "uscale": t.uscale, "vscale": t.vscale,
            "uoffset": t.uoffset, "voffset": t.voffset,
        }
    # Raw number / array = constant.
    return {"kind": tex.TEX_CONST, "value": cval(t)}


_SPEC_SLOTS = {
    "refl": {
        M.MAT_LAMBERTIAN: "reflectance",
        M.MAT_ROUGH_PLASTIC: "diffuse_reflectance",
        M.MAT_DISNEY_DIFFUSE: "base_color",
        M.MAT_DISNEY_METAL: "base_color",
        M.MAT_DISNEY_GLASS: "base_color",
        M.MAT_DISNEY_SHEEN: "base_color",
        M.MAT_DISNEY_BSDF: "base_color",
    },
    "spec_refl": {
        M.MAT_ROUGH_PLASTIC: "specular_reflectance",
        M.MAT_ROUGH_DIELECTRIC: "specular_reflectance",
    },
    "spec_trans": {
        M.MAT_ROUGH_DIELECTRIC: "specular_transmittance",
    },
}

_FLOAT_SLOTS = [
    "roughness", "anisotropic", "subsurface", "metallic", "specular",
    "specular_tint", "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss",
    "specular_transmission",
]

_FLOAT_DEFAULTS = {"clearcoat_gloss": 1.0, "sheen_tint": 0.5, "specular": 0.5}


def _build_materials(materials, pools: _PoolBuilder) -> MaterialTable:
    n = max(len(materials), 1)
    kinds = np.zeros(n, np.int32)
    etas = np.ones(n, np.float32)
    spec_descs = {s: [] for s in _SPEC_SLOTS}
    float_descs = {s: [] for s in _FLOAT_SLOTS}
    mats = materials if materials else [M.Lambertian()]
    for i, m in enumerate(mats):
        kinds[i] = m.kind
        etas[i] = getattr(m, "eta", 1.0)
        for slot, mapping in _SPEC_SLOTS.items():
            attr = mapping.get(m.kind)
            t = getattr(m, attr) if attr else 0.0
            spec_descs[slot].append(_tex_to_desc(t, 3, pools))
        for slot in _FLOAT_SLOTS:
            t = getattr(m, slot, None)
            if t is None:
                t = _FLOAT_DEFAULTS.get(slot, 0.0)
            float_descs[slot].append(_tex_to_desc(t, 1, pools))
    return MaterialTable(
        asarray(kinds),
        asarray(etas),
        tex.make_tex_desc(spec_descs["refl"], 3),
        tex.make_tex_desc(spec_descs["spec_refl"], 3),
        tex.make_tex_desc(spec_descs["spec_trans"], 3),
        *(tex.make_tex_desc(float_descs[s], 1) for s in _FLOAT_SLOTS),
    )


# ---------------------------------------------------------------------------
# Volumes / media (tables only: no volumetric integrator is ported yet)
# ---------------------------------------------------------------------------


def _build_volume(v) -> Tuple[VolumeArrays, bool]:
    if isinstance(v, M.GridVolume):
        data = np.asarray(v.data, np.float32)
        if data.ndim == 3:
            data = data[..., None]
        if data.shape[-1] == 1:
            data = data.repeat(3, axis=-1)
        return (
            VolumeArrays(
                torch.zeros(3, dtype=REAL),
                asarray(data),
                asarray(np.asarray(v.p_min, np.float32)),
                asarray(np.asarray(v.p_max, np.float32)),
                asarray(data.reshape(-1, 3).max(axis=0) * v.scale),
                asarray(v.scale, REAL),
            ),
            True,
        )
    value = v.value if isinstance(v, M.ConstantVolume) else v
    value = np.asarray(value, np.float32).reshape(-1)
    if value.size == 1:
        value = value.repeat(3)
    return (
        VolumeArrays(
            asarray(value),
            torch.zeros((1, 1, 1, 3), dtype=REAL),
            torch.zeros(3, dtype=REAL),
            torch.ones(3, dtype=REAL),
            asarray(value),
            asarray(1.0, REAL),
        ),
        False,
    )


def _build_media(media):
    arrays, phase_kinds, is_hetero, albedo_grid = [], [], [], []
    for m in media:
        g = asarray(getattr(m.phase, "g", 0.0), REAL)
        phase_kinds.append(m.phase.kind)
        if isinstance(m, M.HomogeneousMedium):
            dummy, _ = _build_volume(0.0)
            arrays.append(
                MediumArrays(
                    asarray(np.asarray(m.sigma_a, np.float32).reshape(-1).repeat(3)[:3]),
                    asarray(np.asarray(m.sigma_s, np.float32).reshape(-1).repeat(3)[:3]),
                    dummy, dummy, g,
                )
            )
            is_hetero.append(False)
            albedo_grid.append(False)
        else:
            albedo, a_grid = _build_volume(m.albedo)
            density, _ = _build_volume(m.density)
            arrays.append(
                MediumArrays(torch.zeros(3, dtype=REAL), torch.zeros(3, dtype=REAL),
                             albedo, density, g)
            )
            is_hetero.append(True)
            albedo_grid.append(a_grid)
    return tuple(arrays), tuple(phase_kinds), tuple(is_hetero), tuple(albedo_grid)


# ---------------------------------------------------------------------------
# Main build
# ---------------------------------------------------------------------------


def _i32(vals, n):
    return asarray(vals, INT) if n else torch.zeros(0, dtype=INT)


def build_scene(
    camera: M.Camera,
    materials,
    shapes,
    lights,
    media=(),
    options: M.RenderOptions = None,
    force_bvh: bool = False,
    bvh_builder: str = None,
) -> Scene:
    """bvh_builder: "native", "numpy" or None (native where a C++
    compiler is present), see accel/bvh.build_bvh."""
    options = options or M.RenderOptions()
    pools = _PoolBuilder()
    mat_table = _build_materials(list(materials), pools)

    # ---- geometry ----
    vtx_pos, vtx_normal, vtx_uv = [], [], []
    tri_index, tri_shape, tri_has_n, tri_has_uv = [], [], [], []
    sph_center, sph_radius, sph_shape = [], [], []
    shape_kind, shape_mat, shape_light = [], [], []
    shape_imed, shape_emed, shape_area, shape_prim_off = [], [], [], []
    v_off = 0
    t_seen = 0
    shape_tri_areas = {}
    for sid, s in enumerate(shapes):
        shape_mat.append(s.material_id)
        shape_light.append(s.area_light_id)
        shape_imed.append(s.interior_medium_id)
        shape_emed.append(s.exterior_medium_id)
        if isinstance(s, M.TriangleMesh):
            pos = np.asarray(s.positions, np.float64).reshape(-1, 3)
            idx = np.asarray(s.indices, np.int64).reshape(-1, 3)
            shape_kind.append(SHAPE_MESH)
            shape_prim_off.append(t_seen)
            t_seen += len(idx)
            nrm = (
                np.asarray(s.normals, np.float64).reshape(-1, 3)
                if s.normals is not None and len(s.normals)
                else np.zeros_like(pos)
            )
            uv = (
                np.asarray(s.uvs, np.float64).reshape(-1, 2)
                if s.uvs is not None and len(s.uvs)
                else np.zeros((len(pos), 2))
            )
            vtx_pos.append(pos)
            vtx_normal.append(nrm)
            vtx_uv.append(uv)
            tri_index.append(idx + v_off)
            tri_shape.append(np.full(len(idx), sid, np.int64))
            has_n = s.normals is not None and len(s.normals) > 0
            has_uv = s.uvs is not None and len(s.uvs) > 0
            tri_has_n.append(np.full(len(idx), has_n, bool))
            tri_has_uv.append(np.full(len(idx), has_uv, bool))
            e1 = pos[idx[:, 1]] - pos[idx[:, 0]]
            e2 = pos[idx[:, 2]] - pos[idx[:, 0]]
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
            shape_tri_areas[sid] = areas
            shape_area.append(float(areas.sum()))
            v_off += len(pos)
        else:
            shape_kind.append(SHAPE_SPHERE)
            shape_prim_off.append(len(sph_center))
            sph_center.append(np.asarray(s.center, np.float64))
            sph_radius.append(float(s.radius))
            sph_shape.append(sid)
            shape_area.append(4.0 * np.pi * s.radius * s.radius)

    n_shapes = len(shapes)
    vtx_pos = np.concatenate(vtx_pos, axis=0) if vtx_pos else np.zeros((0, 3))
    vtx_normal = np.concatenate(vtx_normal, axis=0) if vtx_normal else np.zeros((0, 3))
    vtx_uv = np.concatenate(vtx_uv, axis=0) if vtx_uv else np.zeros((0, 2))
    tri_index = np.concatenate(tri_index, axis=0) if tri_index else np.zeros((0, 3), np.int64)
    tri_shape = np.concatenate(tri_shape, axis=0) if tri_shape else np.zeros(0, np.int64)
    tri_has_n = np.concatenate(tri_has_n, axis=0) if len(tri_has_n) else np.zeros(0, bool)
    tri_has_uv = np.concatenate(tri_has_uv, axis=0) if len(tri_has_uv) else np.zeros(0, bool)
    sph_center = np.asarray(sph_center, np.float64).reshape(-1, 3)
    sph_radius = np.asarray(sph_radius, np.float64).reshape(-1)
    n_tris, n_spheres = len(tri_index), len(sph_center)

    tri_v0 = vtx_pos[tri_index[:, 0]] if n_tris else np.zeros((0, 3))
    tri_v1 = vtx_pos[tri_index[:, 1]] if n_tris else np.zeros((0, 3))
    tri_v2 = vtx_pos[tri_index[:, 2]] if n_tris else np.zeros((0, 3))

    use_bf = use_brute_force(n_tris + n_spheres) and not force_bvh
    if use_bf:
        z3 = np.zeros((0, 3), np.float32)
        zi = np.zeros((0,), np.int32)
        bvh = gbvh.BVHArrays(z3, z3, zi, zi, zi, zi)
    else:
        bvh = gbvh.build_bvh(
            tri_v0, tri_v1, tri_v2,
            sph_center if n_spheres else None,
            sph_radius if n_spheres else None,
            builder=bvh_builder,
        )

    geom = Geometry(
        asarray(tri_v0, REAL),
        asarray(tri_v1 - tri_v0, REAL),
        asarray(tri_v2 - tri_v0, REAL),
        asarray(tri_shape, INT),
        asarray(sph_center, REAL),
        asarray(sph_radius, REAL),
        _i32(sph_shape, n_spheres),
        asarray(bvh.bbox_min), asarray(bvh.bbox_max),
        asarray(bvh.first), asarray(bvh.count),
        asarray(bvh.miss), asarray(bvh.prim_order),
    )

    # ---- bounding sphere (reference: src/scene.cpp:29-34) ----
    all_min = np.full(3, np.inf)
    all_max = np.full(3, -np.inf)
    if n_tris:
        all_min = np.minimum(all_min, np.minimum(np.minimum(tri_v0, tri_v1), tri_v2).min(axis=0))
        all_max = np.maximum(all_max, np.maximum(np.maximum(tri_v0, tri_v1), tri_v2).max(axis=0))
    if n_spheres:
        all_min = np.minimum(all_min, (sph_center - sph_radius[:, None]).min(axis=0))
        all_max = np.maximum(all_max, (sph_center + sph_radius[:, None]).max(axis=0))
    if not np.isfinite(all_min).all():
        all_min, all_max = np.zeros(3), np.ones(3)
    bradius = float(np.linalg.norm(all_max - all_min) / 2.0)
    shadow_eps = min(bradius * 1e-5, 0.01)
    isect_eps = min(bradius * 1e-5, 0.01)

    # ---- lights ----
    lights = list(lights)
    n_lights = max(len(lights), 1)
    l_kind = np.zeros(n_lights, np.int32)
    l_shape = np.full(n_lights, -1, np.int32)
    l_intensity = np.zeros((n_lights, 3), np.float32)
    max_light_tris = 1
    for li, l in enumerate(lights):
        if isinstance(l, M.DiffuseAreaLight) and shape_kind[l.shape_id] == SHAPE_MESH:
            max_light_tris = max(max_light_tris, len(shape_tri_areas[l.shape_id]))
    l_tri_cdf = np.tile(np.linspace(0, 1, max_light_tris + 1, dtype=np.float32), (n_lights, 1))
    l_tri_first = np.zeros(n_lights, np.int32)
    powers = np.ones(n_lights, np.float64)

    envmap_light_id = -1
    env_to_world = np.eye(4)
    env_scale = 1.0
    env_desc = [{"kind": tex.TEX_CONST, "value": np.zeros(3)}]
    env_dist = make_table_dist_2d(np.ones(4), 2, 2)

    for li, l in enumerate(lights):
        if isinstance(l, M.DiffuseAreaLight):
            l_kind[li] = LIGHT_AREA
            l_shape[li] = l.shape_id
            l_intensity[li] = np.asarray(l.intensity, np.float32).reshape(-1)[:3]
            # power = luminance * area * pi
            # (reference: src/lights/diffuse_area_light.inl:1-3)
            lum = float(np.dot(l_intensity[li], gspec.LUMA))
            powers[li] = lum * shape_area[l.shape_id] * np.pi
            if shape_kind[l.shape_id] == SHAPE_MESH:
                areas = shape_tri_areas[l.shape_id]
                cdf = np.concatenate([[0.0], np.cumsum(areas)])
                cdf = cdf / max(cdf[-1], 1e-30)
                l_tri_cdf[li, : len(cdf)] = cdf
                l_tri_cdf[li, len(cdf):] = 1.0
                l_tri_first[li] = shape_prim_off[l.shape_id]
        else:  # Envmap
            l_kind[li] = LIGHT_ENVMAP
            envmap_light_id = li
            env_to_world = np.asarray(l.to_world, np.float64)
            env_scale = float(l.scale)
            env_desc = [_tex_to_desc(l.texture, 3, pools)]
            if isinstance(l.texture, M.ImageTexture):
                img = np.asarray(l.texture.data, np.float32)
                if img.ndim == 2:
                    img = img[..., None].repeat(3, -1)
                h, w = img.shape[:2]
                lum = img[..., 0] * gspec.LUMA[0] + img[..., 1] * gspec.LUMA[1] + img[..., 2] * gspec.LUMA[2]
                # shift by half pixel; weight rows by sin(elevation)
                # (reference: src/lights/envmap.inl:75-98)
                sin_elev = np.sin(np.pi * (np.arange(h) + 0.5) / h)
                f = lum * sin_elev[:, None]
                env_dist = make_table_dist_2d(f.ravel(), w, h)
                # power = pi r^2 * mean (reference: src/lights/envmap.inl:1-5)
                powers[li] = np.pi * bradius * bradius * float(f.sum()) / (w * h)
            else:
                val = np.asarray(
                    l.texture.value if isinstance(l.texture, M.ConstantTexture) else l.texture,
                    np.float32,
                ).reshape(-1)
                lum = float(np.dot(np.repeat(val, 3)[:3], gspec.LUMA))
                powers[li] = np.pi * bradius * bradius * lum

    light_dist: TableDist1D = make_table_dist_1d(powers if lights else [1.0])

    light_arrays = LightArrays(
        asarray(l_kind), asarray(l_shape), asarray(l_intensity),
        asarray(l_tri_cdf), asarray(l_tri_first),
        light_dist.pmf, light_dist.cdf,
    )
    envmap_arrays = EnvmapArrays(
        asarray(env_to_world, REAL),
        asarray(np.linalg.inv(env_to_world), REAL),
        asarray(env_scale, REAL),
        tex.make_tex_desc(env_desc, 3),
        env_dist,
    )

    media_arrays, phase_kinds, media_hetero, media_albedo_grid = _build_media(list(media))

    device = DeviceScene(
        geom=geom,
        camera=make_camera_arrays(camera.cam_to_world, camera.fov, camera.width, camera.height),
        shape_kind=_i32(shape_kind, n_shapes),
        shape_material_id=_i32(shape_mat, n_shapes),
        shape_light_id=_i32(shape_light, n_shapes),
        shape_interior_medium=_i32(shape_imed, n_shapes),
        shape_exterior_medium=_i32(shape_emed, n_shapes),
        shape_area=asarray(shape_area, REAL) if n_shapes else torch.zeros(0, dtype=REAL),
        shape_prim_offset=_i32(shape_prim_off, n_shapes),
        vtx_pos=asarray(vtx_pos, REAL),
        vtx_normal=asarray(vtx_normal, REAL),
        vtx_uv=asarray(vtx_uv, REAL),
        tri_index=asarray(tri_index, INT),
        tri_has_normals=asarray(tri_has_n),
        tri_has_uvs=asarray(tri_has_uv),
        materials=mat_table,
        pool3=tex.build_texture_pool(pools.images3, 3),
        pool1=tex.build_texture_pool(pools.images1, 1),
        lights=light_arrays,
        envmap=envmap_arrays,
        media=media_arrays,
    )

    static = SceneStatic(
        width=camera.width,
        height=camera.height,
        n_tris=n_tris,
        n_spheres=n_spheres,
        n_shapes=n_shapes,
        n_lights=len(lights),
        n_materials=len(materials),
        use_brute_force=use_bf,
        used_material_kinds=tuple(sorted({m.kind for m in materials})),
        has_envmap=envmap_light_id >= 0,
        envmap_light_id=envmap_light_id,
        envmap_is_image=env_desc[0].get("kind") == tex.TEX_IMAGE,
        spec_image_slots=tuple(
            bool((getattr(mat_table, s).kind == tex.TEX_IMAGE).any())
            for s in ("refl", "spec_refl", "spec_trans")
        ),
        float_tex_slots=tuple(
            int((getattr(mat_table, s).kind == tex.TEX_CHECKER).any())
            | 2 * int((getattr(mat_table, s).kind == tex.TEX_IMAGE).any())
            for s in _FLOAT_SLOTS
        ),
        filter_kind=camera.filter_kind,
        filter_param=camera.filter_param,
        camera_medium_id=camera.medium_id,
        media_phase_kinds=phase_kinds,
        media_is_hetero=media_hetero,
        media_albedo_is_grid=media_albedo_grid,
        media_grid_res=tuple(
            (
                (int(m.density.grid.shape[2]), int(m.density.grid.shape[1]),
                 int(m.density.grid.shape[0])),
                (int(m.albedo.grid.shape[2]), int(m.albedo.grid.shape[1]),
                 int(m.albedo.grid.shape[0])),
            )
            for m in media_arrays
        ),
        shadow_epsilon=shadow_eps,
        intersection_epsilon=isect_eps,
        options=options,
        any_mesh_light=any(
            isinstance(l, M.DiffuseAreaLight) and shape_kind[l.shape_id] == SHAPE_MESH
            for l in lights
        ),
        any_sphere_light=any(
            isinstance(l, M.DiffuseAreaLight) and shape_kind[l.shape_id] == SHAPE_SPHERE
            for l in lights
        ),
        any_mesh_normals=bool(tri_has_n.any()) if n_tris else False,
        any_mesh_uvs=bool(tri_has_uv.any()) if n_tris else False,
    )
    return Scene(device, static, bvh.builder)
