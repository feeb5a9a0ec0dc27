"""Mitsuba-0.x-dialect XML scene parser; a numpy copy of
gdpt_tpu/scene/parser.py that builds the port's Scene (scene/build.py).

Host-side replacement for reference: src/parsers/parse_scene.cpp (pugixml)
using xml.etree. Same scene-file dialect:

- <default name=.. value=..> with $var substitution
- integrators: path / gradpath / volpath / direct / depth / shadingNormal /
  meanCurvature / rayDifferential / mipmapLevel
- perspective sensor with fovAxis x|y|diagonal|smaller|larger (converted
  to the camera's x-axis fov as in reference: parse_scene.cpp:842-856),
  film + rfilter, sampler sampleCount, camera medium ref
- bsdfs: twosided (unwrapped), diffuse, (rough)plastic, (rough)dielectric,
  disney*, principled, null
- shapes: obj / serialized / ply / sphere / rectangle with per-shape
  emitters and interior/exterior medium refs
- emitters: envmap, point (-> small sphere), directional (-> far quad)
- media: homogeneous / heterogeneous (constvolume / gridvolume)
- textures: bitmap / checkerboard; spectrum/rgb/srgb color literals with
  CIE spectrum->RGB integration
"""

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from gdpt_tpu_torch.core import image as gimage
from gdpt_tpu_torch.core import spectrum as gspec
from gdpt_tpu_torch.core import transform as xf
from gdpt_tpu_torch.scene import build
from gdpt_tpu_torch.scene import filters as gfilters
from gdpt_tpu_torch.scene import loaders
from gdpt_tpu_torch.scene import model as M


class ParseError(RuntimeError):
    pass


def _sub_default(value, defaults):
    if isinstance(value, str) and value.startswith("$"):
        key = value[1:]
        if key not in defaults:
            raise ParseError(f"undefined default ${key}")
        return defaults[key]
    return value


_FLOAT_PREFIX = re.compile(r"^\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _pfloat(value, defaults):
    value = _sub_default(value, defaults)
    if isinstance(value, str):
        # std::stof semantics: parse the leading float prefix and ignore
        # trailing junk (scene files in the wild contain e.g. "1e5+1").
        m = _FLOAT_PREFIX.match(value)
        if m:
            return float(m.group(0))
    return float(value)


def _pint(value, defaults):
    return int(_sub_default(value, defaults))


def _pbool(value, defaults):
    return str(_sub_default(value, defaults)).strip().lower() == "true"


def _pvec3(value, defaults):
    value = _sub_default(value, defaults)
    parts = re.split(r"[,\s]+", value.strip())
    vals = [float(p) for p in parts if p]
    if len(vals) == 1:
        vals = vals * 3
    return np.array(vals[:3], np.float64)


def _parse_spectrum_str(value):
    """'400:0.34, 500:0.3 ...' or a single number
    (reference: parse_scene.cpp:157-172)."""
    items = [v for v in re.split(r"[,\s]+", value.strip()) if v]
    if len(items) == 1 and ":" not in items[0]:
        return None, float(items[0])
    wl, vals = [], []
    for it in items:
        a, b = it.split(":")
        wl.append(float(a))
        vals.append(float(b))
    return np.asarray(wl), np.asarray(vals)


def _parse_color(node, defaults):
    """rgb / spectrum / srgb / float node -> linear RGB
    (reference: parse_scene.cpp:286-311)."""
    tag = node.tag
    val = node.attrib.get("value", "")
    if tag == "rgb" or tag == "color":
        return _pvec3(val, defaults)
    if tag == "spectrum":
        wl, v = _parse_spectrum_str(str(_sub_default(val, defaults)))
        if wl is None:
            return np.full(3, v)
        return gspec.spectrum_to_rgb(wl, v)
    if tag == "srgb":
        s = str(_sub_default(val, defaults))
        if not (s.startswith("#") and len(s) == 7):
            raise ParseError(f"bad srgb literal {s}")
        srgb = np.array(
            [int(s[1:3], 16), int(s[3:5], 16), int(s[5:7], 16)], np.float64
        ) / 255.0
        return gspec.srgb_to_linear(srgb)
    if tag == "float":
        return np.full(3, _pfloat(val, defaults))
    raise ParseError(f"unknown color node <{tag}>")


def _parse_transform(node, defaults):
    m = xf.identity()
    for child in node:
        tag = child.tag.lower()
        a = child.attrib
        if tag == "scale":
            if "value" in a:
                v = _pvec3(a["value"], defaults)
            else:
                v = np.array(
                    [_pfloat(a.get(k, 1.0), defaults) for k in ("x", "y", "z")]
                )
            m = xf.scale(v) @ m
        elif tag == "translate":
            v = np.array(
                [_pfloat(a.get(k, 0.0), defaults) for k in ("x", "y", "z")]
            )
            m = xf.translate(v) @ m
        elif tag == "rotate":
            axis = np.array(
                [_pfloat(a.get(k, 0.0), defaults) for k in ("x", "y", "z")]
            )
            angle = _pfloat(a.get("angle", 0.0), defaults)
            m = xf.rotate(angle, axis) @ m
        elif tag == "lookat":
            origin = _pvec3(a["origin"], defaults)
            target = _pvec3(a["target"], defaults)
            up = _pvec3(a["up"], defaults)
            m = xf.look_at(origin, target, up) @ m
        elif tag == "matrix":
            vals = [float(v) for v in re.split(r"[,\s]+", a["value"].strip()) if v]
            m = np.array(vals, np.float64).reshape(4, 4) @ m
    return m


class _Parser:
    def __init__(self, path):
        self.dir = os.path.dirname(os.path.abspath(path))
        self.defaults = {}
        self.materials = []
        self.material_ids = {}   # xml id -> material index
        self.shapes = []
        self.lights = []
        self.media = []
        self.medium_ids = {}
        self.texture_defs = {}   # xml id -> host texture object
        self.camera = None
        self.options = M.RenderOptions()
        self.output_filename = "image.exr"

    # ---- textures ----

    def _resolve(self, filename):
        return filename if os.path.isabs(filename) else os.path.join(self.dir, filename)

    def _parse_texture_def(self, node):
        ttype = node.attrib.get("type")
        props = {"uscale": 1.0, "vscale": 1.0, "uoffset": 0.0, "voffset": 0.0}
        filename = None
        colors = {}
        for child in node:
            name = child.attrib.get("name", "")
            if name == "filename":
                filename = str(_sub_default(child.attrib["value"], self.defaults))
            elif name in ("uvscale",):
                s = _pfloat(child.attrib["value"], self.defaults)
                props["uscale"] = props["vscale"] = s
            elif name in props:
                props[name] = _pfloat(child.attrib["value"], self.defaults)
            elif name in ("color0", "color1"):
                colors[name] = _parse_color(child, self.defaults)
        if ttype == "bitmap":
            data = gimage.imread(self._resolve(filename))
            return M.ImageTexture(data=data, name=filename, **props)
        if ttype == "checkerboard":
            return M.CheckerboardTexture(
                color0=colors.get("color0", np.full(3, 0.4)),
                color1=colors.get("color1", np.full(3, 0.2)),
                **props,
            )
        raise ParseError(f"unknown texture type {ttype}")

    def _tex_or_color(self, node, scalar=False):
        """A texture-valued parameter: color literal, inline texture or
        <ref> to a named texture."""
        tag = node.tag
        if tag == "texture":
            return self._parse_texture_def(node)
        if tag == "ref":
            rid = node.attrib["id"]
            if rid not in self.texture_defs:
                raise ParseError(f"texture ref {rid} not found")
            return self.texture_defs[rid]
        if tag == "float" and scalar:
            return _pfloat(node.attrib["value"], self.defaults)
        c = _parse_color(node, self.defaults)
        return float(c.mean()) if scalar else c

    # ---- bsdfs ----

    def _parse_bsdf(self, node):
        """Returns (xml_id or None, material or None). 'null' -> None."""
        btype = node.attrib.get("type")
        bid = node.attrib.get("id")
        if btype == "twosided":
            for child in node:
                if child.tag == "bsdf":
                    inner_id, m = self._parse_bsdf(child)
                    return bid or inner_id, m
            raise ParseError("twosided bsdf without nested bsdf")
        if btype == "null":
            return bid, None

        def get(names, default, scalar=False):
            for child in node:
                if child.attrib.get("name") in names:
                    return self._tex_or_color(child, scalar=scalar)
            return default

        def get_float(names, default):
            for child in node:
                if child.attrib.get("name") in names:
                    return _pfloat(child.attrib["value"], self.defaults)
            return default

        def roughness_param(default):
            # 'alpha' is converted via roughness = sqrt(alpha)
            # (reference: parse_scene.cpp alpha_to_roughness).
            for child in node:
                if child.attrib.get("name") == "alpha":
                    a = self._tex_or_color(child, scalar=True)
                    if isinstance(a, (int, float)):
                        return float(np.sqrt(a))
                    if isinstance(a, M.ImageTexture):
                        return M.ImageTexture(
                            data=np.sqrt(np.maximum(a.data, 0.0)),
                            name=a.name + "#sqrt", uscale=a.uscale,
                            vscale=a.vscale, uoffset=a.uoffset, voffset=a.voffset,
                        )
                    return a
            return get(("roughness",), default, scalar=True)

        if btype == "diffuse":
            mat = M.Lambertian(reflectance=get(("reflectance",), np.full(3, 0.5)))
        elif btype in ("roughplastic", "plastic"):
            int_ior = get_float(("intIOR", "int_ior"), 1.49)
            ext_ior = get_float(("extIOR", "ext_ior"), 1.000277)
            mat = M.RoughPlastic(
                diffuse_reflectance=get(
                    ("diffuseReflectance", "diffuse_reflectance"), np.full(3, 0.5)
                ),
                specular_reflectance=get(
                    ("specularReflectance", "specular_reflectance"), np.ones(3)
                ),
                roughness=roughness_param(0.1 if btype == "roughplastic" else 0.01),
                eta=int_ior / ext_ior,
            )
        elif btype in ("roughdielectric", "dielectric"):
            int_ior = get_float(("intIOR", "int_ior"), 1.5046)
            ext_ior = get_float(("extIOR", "ext_ior"), 1.000277)
            mat = M.RoughDielectric(
                specular_reflectance=get(
                    ("specularReflectance", "specular_reflectance"), np.ones(3)
                ),
                specular_transmittance=get(
                    ("specularTransmittance", "specular_transmittance"), np.ones(3)
                ),
                roughness=roughness_param(0.1 if btype == "roughdielectric" else 0.01),
                eta=int_ior / ext_ior,
            )
        elif btype == "disneydiffuse":
            mat = M.DisneyDiffuse(
                base_color=get(("baseColor", "base_color"), np.full(3, 0.5)),
                roughness=get(("roughness",), 0.5, scalar=True),
                subsurface=get(("subsurface",), 0.0, scalar=True),
            )
        elif btype == "disneymetal":
            mat = M.DisneyMetal(
                base_color=get(("baseColor", "base_color"), np.full(3, 0.5)),
                roughness=get(("roughness",), 0.5, scalar=True),
                anisotropic=get(("anisotropic",), 0.0, scalar=True),
            )
        elif btype == "disneyglass":
            mat = M.DisneyGlass(
                base_color=get(("baseColor", "base_color"), np.full(3, 0.5)),
                roughness=get(("roughness",), 0.5, scalar=True),
                anisotropic=get(("anisotropic",), 0.0, scalar=True),
                eta=get_float(("eta",), 1.5),
            )
        elif btype == "disneyclearcoat":
            mat = M.DisneyClearcoat(
                clearcoat_gloss=get(("clearcoatGloss", "clearcoat_gloss"), 1.0, scalar=True),
            )
        elif btype == "disneysheen":
            mat = M.DisneySheen(
                base_color=get(("baseColor", "base_color"), np.full(3, 0.5)),
                sheen_tint=get(("sheenTint", "sheen_tint"), 0.5, scalar=True),
            )
        elif btype in ("disneybsdf", "principled"):
            mat = M.DisneyBSDF(
                base_color=get(("baseColor", "base_color"), np.full(3, 0.5)),
                specular_transmission=get(
                    ("specularTransmission", "specular_transmission",
                     "specTrans", "spec_trans"), 0.0, scalar=True),
                metallic=get(("metallic",), 0.0, scalar=True),
                subsurface=get(("subsurface",), 0.0, scalar=True),
                specular=get(("specular",), 0.5, scalar=True),
                roughness=get(("roughness",), 0.5, scalar=True),
                specular_tint=get(
                    ("specularTint", "specular_tint", "specTint", "spec_tint"),
                    0.0, scalar=True),
                anisotropic=get(("anisotropic",), 0.0, scalar=True),
                sheen=get(("sheen",), 0.0, scalar=True),
                sheen_tint=get(("sheenTint", "sheen_tint"), 0.5, scalar=True),
                clearcoat=get(("clearcoat",), 0.0, scalar=True),
                clearcoat_gloss=get(("clearcoatGloss", "clearcoat_gloss"), 1.0, scalar=True),
                eta=get_float(("eta",), 1.5),
            )
        else:
            raise ParseError(f"unsupported bsdf type {btype}")
        return bid, mat

    def _register_material(self, xml_id, mat):
        """mat may be None (null material) -> id -1."""
        if mat is None:
            if xml_id:
                self.material_ids[xml_id] = -1
            return -1
        idx = len(self.materials)
        self.materials.append(mat)
        if xml_id:
            self.material_ids[xml_id] = idx
        return idx

    # ---- media ----

    def _parse_volume(self, node):
        vtype = node.attrib.get("type")
        if vtype == "constvolume":
            for child in node:
                if child.attrib.get("name") == "value":
                    return M.ConstantVolume(_parse_color(child, self.defaults))
            return M.ConstantVolume(0.0)
        if vtype == "gridvolume":
            for child in node:
                if child.attrib.get("name") == "filename":
                    fn = self._resolve(
                        str(_sub_default(child.attrib["value"], self.defaults))
                    )
                    data, p_min, p_max = loaders.load_vol(fn)
                    return M.GridVolume(data=data, p_min=p_min, p_max=p_max)
            raise ParseError("gridvolume without filename")
        raise ParseError(f"unknown volume type {vtype}")

    def _parse_phase(self, node):
        ptype = node.attrib.get("type")
        if ptype == "isotropic":
            return M.IsotropicPhase()
        if ptype == "hg":
            g = 0.0
            for child in node:
                if child.attrib.get("name") == "g":
                    g = _pfloat(child.attrib["value"], self.defaults)
            return M.HenyeyGreenstein(g=g)
        raise ParseError(f"unknown phase function {ptype}")

    def _parse_medium(self, node):
        mtype = node.attrib.get("type")
        mid = node.attrib.get("id")
        phase = M.IsotropicPhase()
        if mtype == "homogeneous":
            sigma_a = np.full(3, 0.5)
            sigma_s = np.full(3, 0.5)
            scale = 1.0
            for child in node:
                name = child.attrib.get("name", "")
                if name in ("sigmaA", "sigma_a"):
                    sigma_a = _parse_color(child, self.defaults)
                elif name in ("sigmaS", "sigma_s"):
                    sigma_s = _parse_color(child, self.defaults)
                elif name == "scale":
                    scale = _pfloat(child.attrib["value"], self.defaults)
                elif child.tag == "phase":
                    phase = self._parse_phase(child)
            medium = M.HomogeneousMedium(
                sigma_a=sigma_a * scale, sigma_s=sigma_s * scale, phase=phase
            )
        elif mtype == "heterogeneous":
            albedo = M.ConstantVolume(np.ones(3))
            density = M.ConstantVolume(np.ones(3))
            scale = 1.0
            for child in node:
                name = child.attrib.get("name", "")
                if name == "albedo":
                    albedo = self._parse_volume(child)
                elif name == "density":
                    density = self._parse_volume(child)
                elif name == "scale":
                    scale = _pfloat(child.attrib["value"], self.defaults)
                elif child.tag == "phase":
                    phase = self._parse_phase(child)
            # scale applies to density only (reference: parse_scene.cpp:752).
            if isinstance(density, M.GridVolume):
                density.scale = scale
            else:
                density = M.ConstantVolume(np.asarray(density.value) * scale)
            medium = M.HeterogeneousMedium(albedo=albedo, density=density, phase=phase)
        else:
            raise ParseError(f"unknown medium type {mtype}")
        idx = len(self.media)
        self.media.append(medium)
        if mid:
            self.medium_ids[mid] = idx
        return idx

    # ---- shapes ----

    def _parse_shape(self, node):
        stype = node.attrib.get("type")
        material_id = -1
        interior = exterior = -1
        to_world = None
        filename = None
        shape_index = 0
        face_normals = False
        center = np.zeros(3)
        radius = 1.0
        flip_normals = False
        for child in node:
            name = child.attrib.get("name", "")
            if child.tag == "ref":
                rid = child.attrib.get("id")
                if name == "interior":
                    interior = self.medium_ids[rid]
                elif name == "exterior":
                    exterior = self.medium_ids[rid]
                elif rid in self.medium_ids and name in ("interior", "exterior"):
                    pass
                else:
                    if rid not in self.material_ids:
                        raise ParseError(f"material ref {rid} not found")
                    material_id = self.material_ids[rid]
            elif child.tag == "bsdf":
                bid, mat = self._parse_bsdf(child)
                material_id = self._register_material(bid, mat)
            elif child.tag == "medium":
                idx = self._parse_medium(child)
                if name == "interior":
                    interior = idx
                elif name == "exterior":
                    exterior = idx
            elif name == "filename":
                filename = str(_sub_default(child.attrib["value"], self.defaults))
            elif name in ("toWorld", "to_world") and child.tag == "transform":
                to_world = _parse_transform(child, self.defaults)
            elif name in ("shapeIndex", "shape_index"):
                shape_index = _pint(child.attrib["value"], self.defaults)
            elif name in ("faceNormals", "face_normals"):
                face_normals = _pbool(child.attrib["value"], self.defaults)
            elif name in ("flipNormals", "flip_normals"):
                flip_normals = _pbool(child.attrib["value"], self.defaults)
            elif name == "center":
                center = np.array(
                    [_pfloat(child.attrib.get(k, 0.0), self.defaults) for k in "xyz"]
                )
            elif name == "radius":
                radius = _pfloat(child.attrib["value"], self.defaults)

        if stype in ("obj", "serialized", "ply"):
            path = self._resolve(filename)
            if stype == "obj":
                pos, idx, nrm, uvs = loaders.load_obj(path, to_world, face_normals)
            elif stype == "serialized":
                pos, idx, nrm, uvs = loaders.load_serialized(
                    path, shape_index, to_world, face_normals
                )
            else:
                pos, idx, nrm, uvs = loaders.load_ply(path, to_world, face_normals)
            shape = M.TriangleMesh(
                positions=pos, indices=idx, normals=nrm, uvs=uvs,
                material_id=material_id,
                interior_medium_id=interior, exterior_medium_id=exterior,
            )
        elif stype == "sphere":
            shape = M.Sphere(
                center=center, radius=radius, material_id=material_id,
                interior_medium_id=interior, exterior_medium_id=exterior,
            )
        elif stype == "rectangle":
            pos = np.array(
                [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64
            )
            idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
            uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
            nrm = np.tile(
                np.array([[0.0, 0.0, -1.0 if flip_normals else 1.0]]), (4, 1)
            )
            pos, nrm = loaders._apply_to_world(pos, nrm, to_world)
            shape = M.TriangleMesh(
                positions=pos, indices=idx, normals=nrm, uvs=uvs,
                material_id=material_id,
                interior_medium_id=interior, exterior_medium_id=exterior,
            )
        else:
            raise ParseError(f"unknown shape type {stype}")

        # Per-shape area emitter (reference: parse_scene.cpp:1403-1416).
        for child in node:
            if child.tag == "emitter":
                radiance = np.ones(3)
                for gc in child:
                    if gc.attrib.get("name") == "radiance":
                        radiance = _parse_color(gc, self.defaults)
                shape.area_light_id = len(self.lights)
                self.lights.append(
                    M.DiffuseAreaLight(shape_id=len(self.shapes), intensity=radiance)
                )
        self.shapes.append(shape)

    # ---- emitters at scene level ----

    def _parse_emitter(self, node):
        etype = node.attrib.get("type")
        if etype == "envmap":
            filename = None
            scale = 1.0
            to_world = xf.identity()
            for child in node:
                name = child.attrib.get("name", "")
                if name == "filename":
                    filename = str(_sub_default(child.attrib["value"], self.defaults))
                elif name in ("toWorld", "to_world"):
                    to_world = _parse_transform(child, self.defaults)
                elif name == "scale":
                    scale = _pfloat(child.attrib["value"], self.defaults)
            if filename is None:
                raise ParseError("envmap without filename")
            data = gimage.imread(self._resolve(filename))
            self.lights.append(
                M.Envmap(
                    texture=M.ImageTexture(data=data, name=filename),
                    to_world=to_world, scale=scale,
                )
            )
        elif etype == "point":
            # Converted to a tiny spherical light (reference: parse_scene.cpp).
            position = np.zeros(3)
            intensity = np.ones(3)
            for child in node:
                name = child.attrib.get("name", "")
                if name == "position":
                    position = np.array(
                        [_pfloat(child.attrib.get(k, 0.0), self.defaults) for k in "xyz"]
                    )
                elif name == "intensity":
                    intensity = _parse_color(child, self.defaults)
            r = 1e-4
            area = 4.0 * np.pi * r * r
            mat_id = self._register_material(None, M.Lambertian(np.zeros(3)))
            shape = M.Sphere(
                center=position, radius=r, material_id=mat_id,
                area_light_id=len(self.lights),
            )
            self.lights.append(
                M.DiffuseAreaLight(
                    shape_id=len(self.shapes),
                    intensity=intensity * (4.0 * np.pi / area),
                )
            )
            self.shapes.append(shape)
        elif etype == "directional":
            direction = np.array([0.0, 0.0, 1.0])
            intensity = np.ones(3)
            for child in node:
                name = child.attrib.get("name", "")
                if name == "direction":
                    direction = np.array(
                        [_pfloat(child.attrib.get(k, 0.0), self.defaults) for k in "xyz"]
                    )
                elif name in ("toWorld", "to_world"):
                    direction = xf.xform_vector(
                        _parse_transform(child, self.defaults), direction
                    )
                elif name == "irradiance":
                    intensity = _parse_color(child, self.defaults)
            direction = direction / np.linalg.norm(direction)
            # Far-away small quad facing the scene (reference: parse_scene.cpp).
            def coord_system(n):
                if n[2] < -1 + 1e-6:
                    return np.array([0.0, -1.0, 0.0]), np.array([-1.0, 0.0, 0.0])
                a = 1.0 / (1.0 + n[2])
                b = -n[0] * n[1] * a
                return (
                    np.array([1 - n[0] * n[0] * a, b, -n[0]]),
                    np.array([b, 1 - n[1] * n[1] * a, -n[1]]),
                )

            t, bt = coord_system(-direction)
            length, dist = 1e-3, 1e3
            pos = np.stack([
                0.5 * length * (-t - bt) - dist * direction,
                0.5 * length * (t - bt) - dist * direction,
                0.5 * length * (t + bt) - dist * direction,
                0.5 * length * (-t + bt) - dist * direction,
            ])
            mesh = M.TriangleMesh(
                positions=pos,
                indices=np.array([[0, 1, 2], [0, 2, 3]], np.int64),
                normals=np.tile(direction, (4, 1)),
                material_id=self._register_material(None, M.Lambertian(np.zeros(3))),
                area_light_id=len(self.lights),
            )
            self.lights.append(
                M.DiffuseAreaLight(
                    shape_id=len(self.shapes),
                    intensity=intensity * (dist * dist) / (length * length),
                )
            )
            self.shapes.append(mesh)
        else:
            raise ParseError(f"unknown emitter type {etype}")

    # ---- sensor ----

    def _parse_sensor(self, node):
        fov = 45.0
        fov_axis = "x"
        to_world = xf.identity()
        width = height = 256
        filter_kind = gfilters.FILTER_BOX
        filter_param = 1.0
        medium_id = -1
        spp = None
        for child in node:
            name = child.attrib.get("name", "")
            if name == "fov":
                fov = _pfloat(child.attrib["value"], self.defaults)
            elif name in ("fovAxis", "fov_axis"):
                fov_axis = str(_sub_default(child.attrib["value"], self.defaults))
            elif name in ("toWorld", "to_world"):
                to_world = _parse_transform(child, self.defaults)
            elif child.tag == "film":
                for gc in child:
                    gname = gc.attrib.get("name", "")
                    if gname == "width":
                        width = _pint(gc.attrib["value"], self.defaults)
                    elif gname == "height":
                        height = _pint(gc.attrib["value"], self.defaults)
                    elif gname == "filename":
                        self.output_filename = str(
                            _sub_default(gc.attrib["value"], self.defaults)
                        )
                    elif gc.tag == "rfilter":
                        ftype = gc.attrib.get("type")
                        if ftype == "box":
                            filter_kind, filter_param = gfilters.FILTER_BOX, 1.0
                        elif ftype == "tent":
                            filter_kind, filter_param = gfilters.FILTER_TENT, 1.0
                        elif ftype == "gaussian":
                            filter_kind, filter_param = gfilters.FILTER_GAUSSIAN, 0.5
                            for ggc in gc:
                                if ggc.attrib.get("name") == "stddev":
                                    filter_param = _pfloat(
                                        ggc.attrib["value"], self.defaults
                                    )
                        # width-parameterized box/tent
                        for ggc in gc:
                            if ggc.attrib.get("name") in ("width", "radius") and ftype in ("box", "tent"):
                                filter_param = _pfloat(ggc.attrib["value"], self.defaults)
            elif child.tag == "sampler":
                for gc in child:
                    if gc.attrib.get("name") in ("sampleCount", "sample_count"):
                        spp = _pint(gc.attrib["value"], self.defaults)
            elif child.tag == "ref":
                rid = child.attrib.get("id")
                if rid in self.medium_ids:
                    medium_id = self.medium_ids[rid]
            elif child.tag == "medium":
                medium_id = self._parse_medium(child)

        # Convert fov to the camera's x axis (reference: parse_scene.cpp:842-856).
        aspect = width / height
        if fov_axis == "y" or (fov_axis == "smaller" and height < width) or (
            fov_axis == "larger" and width < height
        ):
            fov = np.degrees(2 * np.arctan(np.tan(np.radians(fov) / 2) * aspect))
        elif fov_axis == "diagonal":
            diagonal = 2 * np.tan(np.radians(fov) / 2)
            w = diagonal / np.sqrt(1 + 1 / (aspect * aspect))
            fov = np.degrees(2 * np.arctan(w / 2))

        self.camera = M.Camera(
            cam_to_world=to_world, fov=fov, width=width, height=height,
            filter_kind=filter_kind, filter_param=filter_param,
            medium_id=medium_id,
        )
        return spp

    # ---- top level ----

    def parse(self, root):
        spp = None
        for node in root:
            tag = node.tag
            if tag == "default":
                self.defaults[node.attrib["name"]] = node.attrib["value"]
            elif tag == "integrator":
                self._parse_integrator(node)
            elif tag == "sensor":
                spp = self._parse_sensor(node)
            elif tag == "bsdf":
                bid, mat = self._parse_bsdf(node)
                self._register_material(bid, mat)
            elif tag == "texture":
                tid = node.attrib.get("id")
                self.texture_defs[tid] = self._parse_texture_def(node)
            elif tag == "shape":
                self._parse_shape(node)
            elif tag == "emitter":
                self._parse_emitter(node)
            elif tag == "medium":
                self._parse_medium(node)
        if spp is not None:
            self.options = type(self.options)(
                **{**self.options.__dict__, "samples_per_pixel": spp}
            )

    def _parse_integrator(self, node):
        itype = node.attrib.get("type")
        kw = {}
        name_map = {
            "path": "path", "gradpath": "gradpath", "volpath": "volpath",
            "depth": "depth", "shadingNormal": "shading_normal",
            "shading_normal": "shading_normal",
            "meanCurvature": "mean_curvature", "mean_curvature": "mean_curvature",
            "rayDifferential": "ray_differential",
            "ray_differential": "ray_differential",
            "mipmapLevel": "mipmap_level", "mipmap_level": "mipmap_level",
        }
        if itype == "direct":
            kw["integrator"] = "path"
            kw["max_depth"] = 2
        elif itype in name_map:
            kw["integrator"] = name_map[itype]
        else:
            raise ParseError(f"unsupported integrator {itype}")
        for child in node:
            name = child.attrib.get("name", "")
            if name in ("maxDepth", "max_depth"):
                kw["max_depth"] = _pint(child.attrib["value"], self.defaults)
            elif name in ("rrDepth", "rr_depth"):
                kw["rr_depth"] = _pint(child.attrib["value"], self.defaults)
            elif name == "version":
                kw["vol_path_version"] = _pint(child.attrib["value"], self.defaults)
            elif name in ("maxNullCollisions", "max_null_collisions"):
                kw["max_null_collisions"] = _pint(child.attrib["value"], self.defaults)
        self.options = M.RenderOptions(**{**self.options.__dict__, **kw})


def parse_scene(filename, force_bvh=False, width=None, height=None, spp=None):
    """Parse a Mitsuba-dialect XML file into a Scene of host tensors
    (reference: parse_scene.cpp:1615-1639). Returns (Scene, output_filename).
    width/height/spp optionally override the scene's film settings."""
    tree = ET.parse(filename)
    root = tree.getroot()
    p = _Parser(filename)
    p.parse(root)
    if p.camera is None:
        raise ParseError("scene has no sensor")
    if width or height:
        from dataclasses import replace

        p.camera = replace(
            p.camera,
            width=width or p.camera.width,
            height=height or p.camera.height,
        )
    if spp:
        p.options = M.RenderOptions(
            **{**p.options.__dict__, "samples_per_pixel": spp}
        )
    scene = build.build_scene(
        p.camera, p.materials, p.shapes, p.lights, p.media,
        options=p.options, force_bvh=force_bvh,
    )
    return scene, p.output_filename
