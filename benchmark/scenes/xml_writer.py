"""Write a scene description (benchmark/scenes/*.py) as Mitsuba-dialect XML.

A frozen copy of gdpt_tpu_torch/scene/xml_writer.py's forms for the
descriptions the benchmark makes, in the file form the program's own
front end (gdpt_tpu_torch.scene.parser) reads:

- a material is an RGB triple, a Lambertian reflectance
  (`<bsdf type="diffuse">`), or a dict `{"type": "disneymetal",
  "base_color": rgb, "roughness": r}` or `{"type": "roughdielectric",
  "roughness": r, "int_ior": a, "ext_ior": b}` (both indices written, so
  eta is a / b and no parser default enters);
- a shape is a triangle mesh `{"positions", "indices", "material",
  "emitter"}`, written as a binary little-endian PLY beside the XML
  (positions in double precision, face normals), or a sphere
  `{"center": (x, y, z), "radius": r, "material": k, "emitter"}`; an
  `emitter` is an area light's RGB radiance or None. Shapes stay in list
  order, as the parser numbers area lights in shape order;
- the perspective camera with its filter, and the render options.

Floats are written by repr. Anything else in a description raises
ValueError naming the entry.
"""

import os

import numpy as np

_FILTERS = {"box": "width", "tent": "width", "gaussian": "stddev"}


def _num(x):
    return repr(float(x))


def _rgb(name, v):
    return f'<rgb name="{name}" value="{", ".join(_num(c) for c in v)}"/>'


def write_ply(path, positions, indices):
    """A binary little-endian PLY: double x, y, z; uchar/int face lists."""
    verts = np.asarray(positions, np.float64).reshape(-1, 3).astype("<f8")
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    faces = np.zeros(len(idx), dtype=[("n", "u1"), ("i", "<i4", 3)])
    faces["n"], faces["i"] = 3, idx
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(verts)}",
              "property double x", "property double y", "property double z",
              f"element face {len(idx)}", "property list uchar int vertex_indices",
              "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(verts.tobytes())
        f.write(faces.tobytes())


_METAL = {"type", "base_color", "roughness"}
_DIELECTRIC = {"type", "roughness", "int_ior", "ext_ior"}
_MESH = {"positions", "indices", "material", "emitter"}
_SPHERE = {"center", "radius", "material", "emitter"}


def _float(name, x):
    return f'<float name="{name}" value="{_num(x)}"/>'


def _material(k, m):
    """Material k of a description as a <bsdf> element."""
    if isinstance(m, dict):
        if m.get("type") == "disneymetal" and set(m) == _METAL:
            body = _rgb("baseColor", m["base_color"]) + _float("roughness", m["roughness"])
        elif m.get("type") == "roughdielectric" and set(m) == _DIELECTRIC:
            body = (_float("roughness", m["roughness"]) + _float("intIOR", m["int_ior"])
                    + _float("extIOR", m["ext_ior"]))
        else:
            raise ValueError(f"material {k} has no XML form here: {m!r}")
        return f'<bsdf type="{m["type"]}" id="mat{k}">{body}</bsdf>'
    refl = np.asarray(m)
    if refl.shape != (3,) or not np.issubdtype(refl.dtype, np.number):
        raise ValueError(f"material {k} has no XML form here: {m!r}")
    return f'<bsdf type="diffuse" id="mat{k}">{_rgb("reflectance", m)}</bsdf>'


def _shape(directory, k, s):
    """Shape k of a description as the lines of its <shape> element (a
    mesh's PLY written beside the XML)."""
    keys = set(s) if isinstance(s, dict) else None
    if keys == _MESH:
        write_ply(os.path.join(directory, f"mesh{k}.ply"), s["positions"], s["indices"])
        out = ['<shape type="ply">', f'<string name="filename" value="mesh{k}.ply"/>',
               '<boolean name="faceNormals" value="true"/>']
    elif keys == _SPHERE:
        x, y, z = (_num(c) for c in np.asarray(s["center"], np.float64).reshape(3))
        out = ['<shape type="sphere">', f'<point name="center" x="{x}" y="{y}" z="{z}"/>',
               _float("radius", s["radius"])]
    else:
        raise ValueError(f"shape {k} has no XML form here: keys {sorted(keys or ())}")
    out.append(f'<ref id="mat{s["material"]}"/>')
    if s["emitter"] is not None:
        out.append(f'<emitter type="area">{_rgb("radiance", s["emitter"])}</emitter>')
    return out + ["</shape>"]


def write_scene(directory, desc):
    """Write `desc` to `directory`/scene.xml, meshes beside it; returns the
    XML's path."""
    os.makedirs(directory, exist_ok=True)
    opts, cam = desc["options"], desc["camera"]
    out = ['<?xml version="1.0"?>', '<scene version="0.5.0">',
           f'<integrator type="{opts["integrator"]}">',
           f'<integer name="maxDepth" value="{opts["max_depth"]}"/>',
           f'<integer name="rrDepth" value="{opts["rr_depth"]}"/>',
           '<integer name="version" value="0"/>',
           '<integer name="maxNullCollisions" value="1000"/>',
           '</integrator>']
    matrix = " ".join(_num(x) for x in np.asarray(cam["cam_to_world"], np.float64).ravel())
    out += ['<sensor type="perspective">',
            f'<float name="fov" value="{_num(cam["fov"])}"/>',
            '<string name="fovAxis" value="x"/>',
            f'<transform name="toWorld"><matrix value="{matrix}"/></transform>',
            '<sampler type="independent">'
            f'<integer name="sampleCount" value="{opts["spp"]}"/></sampler>',
            '<film type="hdrfilm">',
            f'<integer name="width" value="{cam["width"]}"/>',
            f'<integer name="height" value="{cam["height"]}"/>',
            f'<rfilter type="{cam["filter"]}"><float name="{_FILTERS[cam["filter"]]}" '
            f'value="{_num(cam["filter_param"])}"/></rfilter>', '</film>', '</sensor>']
    out += [_material(k, m) for k, m in enumerate(desc["materials"])]
    for k, s in enumerate(desc["shapes"]):
        out += _shape(directory, k, s)
    out.append("</scene>")
    path = os.path.join(directory, "scene.xml")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path
