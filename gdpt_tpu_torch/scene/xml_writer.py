"""Write a scene description as a Mitsuba-dialect XML file (the port's own).

The inverse of scene/parser.py for the descriptions scene/presets.py
makes: Lambertian materials of a constant reflectance, triangle meshes
(binary little-endian PLY files beside the XML, positions, normals and
uvs in double precision), spheres, area lights, homogeneous and
heterogeneous media (grids as .vol files), the perspective camera with
its filter and medium, and the render options. parse_scene of the
written file builds the scene that build.build_scene builds from the
same description, leaf for leaf (floats are written by repr). It drives
the file front end where no scene file is at hand (the tests,
chip_smoke.py). Anything else in a description raises ValueError.
"""

import os
import struct

import numpy as np

from gdpt_tpu_torch.scene import filters as gfilters
from gdpt_tpu_torch.scene import model as M

_FILTERS = {gfilters.FILTER_BOX: ("box", "width"), gfilters.FILTER_TENT: ("tent", "width"),
            gfilters.FILTER_GAUSSIAN: ("gaussian", "stddev")}


def _num(x):
    return repr(float(x))


def _rgb(name, v):
    v = np.broadcast_to(np.asarray(v, np.float64).reshape(-1), (3,))
    return f'<rgb name="{name}" value="{", ".join(_num(c) for c in v)}"/>'


def write_ply(path, positions, indices, normals=None, uvs=None):
    """A binary little-endian PLY: double vertex properties, uchar/int
    face lists."""
    cols = [np.asarray(positions, np.float64).reshape(-1, 3)]
    names = ["x", "y", "z"]
    if normals is not None and len(normals):
        cols.append(np.asarray(normals, np.float64).reshape(-1, 3))
        names += ["nx", "ny", "nz"]
    if uvs is not None and len(uvs):
        cols.append(np.asarray(uvs, np.float64).reshape(-1, 2))
        names += ["u", "v"]
    verts = np.concatenate(cols, axis=1).astype("<f8")
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    faces = np.zeros(len(idx), dtype=[("n", "u1"), ("i", "<i4", 3)])
    faces["n"], faces["i"] = 3, idx
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(verts)}"]
    header += [f"property double {n}" for n in names]
    header += [f"element face {len(idx)}", "property list uchar int vertex_indices",
               "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(verts.tobytes())
        f.write(faces.tobytes())


def write_vol(path, data, p_min, p_max):
    """A Mitsuba .vol grid (VOL v3, float32): data (z, y, x, c)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    zres, yres, xres, c = data.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<5i", 1, xres, yres, zres, c))
        f.write(struct.pack("<6f", *np.asarray(p_min, np.float64), *np.asarray(p_max, np.float64)))
        f.write(data.astype("<f4").tobytes())


def _volume(directory, name, v, tag):
    if isinstance(v, M.GridVolume):
        write_vol(os.path.join(directory, f"{tag}.vol"), v.data, v.p_min, v.p_max)
        return (f'<volume name="{name}" type="gridvolume">'
                f'<string name="filename" value="{tag}.vol"/></volume>')
    value = v.value if isinstance(v, M.ConstantVolume) else v
    return f'<volume name="{name}" type="constvolume">{_rgb("value", value)}</volume>'


def _phase(phase):
    if isinstance(phase, M.HenyeyGreenstein):
        return f'<phase type="hg"><float name="g" value="{_num(phase.g)}"/></phase>'
    return '<phase type="isotropic"/>'


def _medium(directory, k, m):
    out = [f'<medium type="{"homogeneous" if isinstance(m, M.HomogeneousMedium) else "heterogeneous"}"'
           f' id="medium{k}">']
    if isinstance(m, M.HomogeneousMedium):
        out += [_rgb("sigmaA", m.sigma_a), _rgb("sigmaS", m.sigma_s)]
    else:
        density = m.density
        if isinstance(density, M.GridVolume) and density.scale != 1.0:
            out.append(f'<float name="scale" value="{_num(density.scale)}"/>')
        out += [_volume(directory, "albedo", m.albedo, f"medium{k}_albedo"),
                _volume(directory, "density", density, f"medium{k}_density")]
    out += [_phase(m.phase), "</medium>"]
    return "\n".join(out)


def _shape(directory, k, s, lights):
    out = []
    if isinstance(s, M.TriangleMesh):
        write_ply(os.path.join(directory, f"mesh{k}.ply"), s.positions, s.indices,
                  s.normals, s.uvs)
        out += ['<shape type="ply">', f'<string name="filename" value="mesh{k}.ply"/>']
        if s.normals is None or not len(s.normals):
            out.append('<boolean name="faceNormals" value="true"/>')
    elif isinstance(s, M.Sphere):
        c = np.asarray(s.center, np.float64)
        out += ['<shape type="sphere">',
                f'<point name="center" x="{_num(c[0])}" y="{_num(c[1])}" z="{_num(c[2])}"/>',
                f'<float name="radius" value="{_num(s.radius)}"/>']
    else:
        raise ValueError(f"shape {type(s).__name__} has no XML form here")
    if s.material_id >= 0:
        out.append(f'<ref id="mat{s.material_id}"/>')
    for side, mid in (("interior", s.interior_medium_id), ("exterior", s.exterior_medium_id)):
        if mid >= 0:
            out.append(f'<ref name="{side}" id="medium{mid}"/>')
    if s.area_light_id >= 0:
        out.append(f'<emitter type="area">{_rgb("radiance", lights[s.area_light_id].intensity)}'
                   '</emitter>')
    return "\n".join(out + ["</shape>"])


def write_scene(directory, camera, materials, shapes, lights, media=(), options=None,
                force_bvh=False, output=None):
    """Write the description that build.build_scene takes (same argument
    names) to `directory`/scene.xml, meshes and grids beside it; returns
    the XML's path. force_bvh is parse_scene's argument, not a file's,
    and must be False; `output` names the film's output file."""
    options = options or M.RenderOptions()
    if force_bvh:
        raise ValueError("force_bvh is an argument of parse_scene, not of a scene file")
    if options.gdpt_alpha != M.RenderOptions().gdpt_alpha:
        raise ValueError("gdpt_alpha has no XML form")
    for i, light in enumerate(lights):
        # The parser numbers the area lights in the order of their shapes.
        if not isinstance(light, M.DiffuseAreaLight) or shapes[light.shape_id].area_light_id != i \
                or (i and light.shape_id <= lights[i - 1].shape_id):
            raise ValueError(f"light {i}: only area lights, numbered in shape order")
    os.makedirs(directory, exist_ok=True)
    out = ['<?xml version="1.0"?>', '<scene version="0.5.0">',
           f'<integrator type="{options.integrator}">',
           f'<integer name="maxDepth" value="{options.max_depth}"/>',
           f'<integer name="rrDepth" value="{options.rr_depth}"/>',
           f'<integer name="version" value="{options.vol_path_version}"/>',
           f'<integer name="maxNullCollisions" value="{options.max_null_collisions}"/>',
           '</integrator>']
    out += [_medium(directory, k, m) for k, m in enumerate(media)]
    rfilter, param = _FILTERS[camera.filter_kind]
    matrix = " ".join(_num(x) for x in np.asarray(camera.cam_to_world, np.float64).reshape(-1))
    out += ['<sensor type="perspective">',
            f'<float name="fov" value="{_num(camera.fov)}"/>',
            '<string name="fovAxis" value="x"/>',
            f'<transform name="toWorld"><matrix value="{matrix}"/></transform>',
            '<sampler type="independent">'
            f'<integer name="sampleCount" value="{options.samples_per_pixel}"/></sampler>',
            '<film type="hdrfilm">',
            f'<integer name="width" value="{camera.width}"/>',
            f'<integer name="height" value="{camera.height}"/>']
    if output:
        out.append(f'<string name="filename" value="{output}"/>')
    out += [f'<rfilter type="{rfilter}"><float name="{param}" '
            f'value="{_num(camera.filter_param)}"/></rfilter>', '</film>']
    if camera.medium_id >= 0:
        out.append(f'<ref id="medium{camera.medium_id}"/>')
    out.append('</sensor>')
    for k, mat in enumerate(materials):
        if not isinstance(mat, M.Lambertian) or not isinstance(
                mat.reflectance, (int, float, np.ndarray, list, tuple)):
            raise ValueError(f"material {k}: only Lambertian of a constant reflectance")
        out.append(f'<bsdf type="diffuse" id="mat{k}">{_rgb("reflectance", mat.reflectance)}'
                   '</bsdf>')
    out += [_shape(directory, k, s, lights) for k, s in enumerate(shapes)]
    out.append("</scene>")
    path = os.path.join(directory, "scene.xml")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path
