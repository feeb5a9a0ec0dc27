"""Write a scene description (benchmark/scenes/*.py) as Mitsuba-dialect XML.

A frozen copy of gdpt_tpu_torch/scene/xml_writer.py for the descriptions
the benchmark makes: Lambertian materials of a constant reflectance,
triangle meshes as binary little-endian PLY files beside the XML
(positions in double precision, face normals), area lights on meshes, the
perspective camera with its filter, and the render options. The program
reads the file with its own front end (gdpt_tpu_torch.scene.parser).
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
    for k, refl in enumerate(desc["materials"]):
        out.append(f'<bsdf type="diffuse" id="mat{k}">{_rgb("reflectance", refl)}</bsdf>')
    for k, s in enumerate(desc["shapes"]):
        write_ply(os.path.join(directory, f"mesh{k}.ply"), s["positions"], s["indices"])
        out += ['<shape type="ply">', f'<string name="filename" value="mesh{k}.ply"/>',
                '<boolean name="faceNormals" value="true"/>', f'<ref id="mat{s["material"]}"/>']
        if s["emitter"] is not None:
            out.append(f'<emitter type="area">{_rgb("radiance", s["emitter"])}</emitter>')
        out.append("</shape>")
    out.append("</scene>")
    path = os.path.join(directory, "scene.xml")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path
