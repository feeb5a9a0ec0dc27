"""The port's scene front end (scene/parser.py, scene/loaders.py,
scene/xml_writer.py) against gdpt_tpu's.

Every XML is parsed by both packages; both are numpy host code, so the
SceneStatic fields, every DeviceScene leaf (bit for bit) and the output
name must be equal. Renders of one parsed file, brute force and BVH, are
held to the reference's at the gate of tests/test_torch_path.py.
"""

import dataclasses
import os
import struct
import textwrap
import zlib

import jax
import numpy as np
import pytest
import torch

from gdpt_tpu.core import image as jimage
from gdpt_tpu.integrators import path_soa as jpath
from gdpt_tpu.scene import loaders as jloaders
from gdpt_tpu.scene import parser as jparser
from gdpt_tpu_torch import convert
from gdpt_tpu_torch.core import image as timage
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.scene import loaders as tloaders
from gdpt_tpu_torch.scene import parser as tparser
from gdpt_tpu_torch.scene import presets as tpresets
from gdpt_tpu_torch.scene import xml_writer

from test_parser import HAS_REF, REF  # the reference's scene files, where mounted
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)


def _write_scene(tmp_path, body):
    p = tmp_path / "scene.xml"
    p.write_text(
        '<?xml version="1.0"?>\n<scene version="0.5.0">\n' + textwrap.dedent(body) + "\n</scene>"
    )
    return str(p)


def assert_same_parse(path, **kw):
    """Both packages parse `path` to equal scenes; returns (reference
    scene, port scene)."""
    js, jout = jparser.parse_scene(path, **kw)
    ts, tout = tparser.parse_scene(path, **kw)
    assert tout == jout
    assert dataclasses.asdict(ts.static) == dataclasses.asdict(js.static)
    jl = jax.tree_util.tree_leaves(js.device)
    tl = convert.tree_leaves(ts.device)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        if not isinstance(b, torch.Tensor):  # a Python scalar field
            assert a == b, f"leaf {i}"
            continue
        a, b = np.asarray(a), b.numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f"leaf {i}"
        np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
    return js, ts


# The scenes of tests/test_parser.py.
MINIMAL = """
    <default name="res" value="32"/>
    <default name="depth" value="3"/>
    <integrator type="path">
        <integer name="maxDepth" value="$depth"/>
    </integrator>
    <sensor type="perspective">
        <float name="fov" value="45"/>
        <transform name="toWorld">
            <lookAt origin="0, 0, -3" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent">
            <integer name="sampleCount" value="7"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="$res"/>
            <integer name="height" value="$res"/>
            <rfilter type="tent"/>
        </film>
    </sensor>
    <bsdf type="twosided" id="white">
        <bsdf type="diffuse">
            <rgb name="reflectance" value="0.7 0.6 0.5"/>
        </bsdf>
    </bsdf>
    <shape type="sphere">
        <point name="center" x="0" y="0" z="0"/>
        <float name="radius" value="1"/>
        <ref id="white"/>
        <emitter type="area">
            <rgb name="radiance" value="2 3 4"/>
        </emitter>
    </shape>
    <shape type="rectangle">
        <transform name="toWorld">
            <scale value="5"/>
            <translate z="3"/>
        </transform>
        <ref id="white"/>
    </shape>
    """

SPECTRUM = """
    <integrator type="direct"/>
    <sensor type="perspective">
        <float name="fov" value="45"/>
        <film type="hdrfilm">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
        </film>
    </sensor>
    <bsdf type="diffuse" id="m">
        <spectrum name="reflectance" value="400:0.5, 700:0.5"/>
    </bsdf>
    <shape type="sphere">
        <ref id="m"/>
    </shape>
    """

CSTYLE = """
    <integrator type="path"/>
    <sensor type="perspective">
        <float name="fov" value="45"/>
        <film type="hdrfilm"><integer name="width" value="8"/><integer name="height" value="8"/></film>
    </sensor>
    <shape type="sphere">
        <float name="radius" value="1e2+5"/>
        <bsdf type="diffuse"/>
    </shape>
    """


def test_minimal_scene_with_defaults(tmp_path):
    from gdpt_tpu_torch.scene.filters import FILTER_TENT

    _, scene = assert_same_parse(_write_scene(tmp_path, MINIMAL))
    s = scene.static
    assert s.width == 32 and s.height == 32
    assert s.options.max_depth == 3
    assert s.options.samples_per_pixel == 7
    assert s.n_spheres == 1 and s.n_tris == 2
    assert s.n_lights == 1
    assert s.filter_kind == FILTER_TENT


def test_spectrum_literal_parsing(tmp_path):
    _, scene = assert_same_parse(_write_scene(tmp_path, SPECTRUM))
    assert scene.static.options.max_depth == 2
    refl = scene.device.materials.refl.value[0].numpy()
    assert (refl > 0.2).all() and (refl < 0.8).all()


def test_cstyle_float_prefix(tmp_path):
    _, scene = assert_same_parse(_write_scene(tmp_path, CSTYLE))
    assert float(scene.device.geom.sph_radius[0]) == 100.0


def test_undefined_default_raises(tmp_path):
    path = _write_scene(tmp_path, MINIMAL.replace('<default name="res" value="32"/>', ""))
    with pytest.raises(tparser.ParseError, match="res"):
        tparser.parse_scene(path)


@pytest.mark.parametrize("axis", ["x", "y", "diagonal", "smaller", "larger"])
def test_fov_axis(tmp_path, axis):
    body = MINIMAL.replace('<float name="fov" value="45"/>',
                           f'<float name="fov" value="45"/><string name="fovAxis" value="{axis}"/>')
    body = body.replace('<integer name="height" value="$res"/>',
                        '<integer name="height" value="20"/>')
    assert_same_parse(_write_scene(tmp_path, body))


def test_overrides(tmp_path):
    js, ts = assert_same_parse(_write_scene(tmp_path, MINIMAL), width=12, height=10, spp=3)
    assert (ts.static.width, ts.static.height, ts.static.options.samples_per_pixel) == (12, 10, 3)


def _write_serialized(path, meshes):
    """A version-4 Mitsuba .serialized file of float32 meshes (positions,
    indices, and uvs where given), with its offset table."""
    out, offsets = b"", []
    for pos, idx, uvs in meshes:
        flags = 0x0002 if uvs is not None else 0
        body = struct.pack("<I", flags) + b"mesh\0" + struct.pack("<QQ", len(pos), len(idx))
        body += np.asarray(pos, "<f4").tobytes()
        if uvs is not None:
            body += np.asarray(uvs, "<f4").tobytes()
        body += np.asarray(idx, "<u4").tobytes()
        offsets.append(len(out))
        out += struct.pack("<HH", 0x041C, 4) + zlib.compress(body)
    out += np.asarray(offsets, "<u8").tobytes() + struct.pack("<I", len(meshes))
    with open(path, "wb") as f:
        f.write(out)


def _assets(tmp_path):
    """Meshes, grids and images for the every-kind scene."""
    rng = np.random.default_rng(5)
    (tmp_path / "quad.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\nf -4/-4/-1 -3/-3/-1 -2/-2/-1 -1/-1/-1\n")
    (tmp_path / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    (tmp_path / "ascii.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\nproperty float y\n"
        "property float z\nproperty float nx\nproperty float ny\nproperty float nz\n"
        "property float u\nproperty float v\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0 0 0 1 0 0\n1 0 0 0 0 1 1 0\n1 1 0 0 0 1 1 1\n0 1 0 0 0 1 0 1\n4 0 1 2 3\n")
    ico_pos, ico_idx = tpresets.icosphere(0, (0.0, 0.0, 0.0), 1.0)
    xml_writer.write_ply(str(tmp_path / "ico.ply"), ico_pos, ico_idx, uvs=ico_pos[:, :2])
    _write_serialized(str(tmp_path / "meshes.serialized"), [
        (ico_pos, ico_idx, None),
        (np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0]]), np.array([[0, 1, 2]]),
         np.array([[0, 0], [1, 0], [1, 1]]))])
    xml_writer.write_vol(str(tmp_path / "density.vol"), rng.random((4, 3, 5, 1)),
                         (-1, -1, -1), (1, 1, 1))
    xml_writer.write_vol(str(tmp_path / "albedo.vol"), rng.random((4, 3, 5, 3)),
                         (-1, -1, -1), (1, 1, 1))
    timage.write_exr(str(tmp_path / "wall.exr"), rng.random((16, 8, 3)))
    timage.write_pfm(str(tmp_path / "rough.pfm"), rng.random((8, 8)))
    timage.write_exr(str(tmp_path / "env.exr"), rng.random((8, 16, 3)) * 2)


EVERY_KIND = """
    <default name="spp" value="3"/>
    <integrator type="volpath">
        <integer name="maxDepth" value="5"/><integer name="rrDepth" value="2"/>
        <integer name="version" value="6"/><integer name="maxNullCollisions" value="64"/>
    </integrator>
    <medium type="homogeneous" id="fog">
        <rgb name="sigmaA" value="0.1, 0.2, 0.3"/><spectrum name="sigmaS" value="0.5"/>
        <float name="scale" value="2"/>
        <phase type="hg"><float name="g" value="0.3"/></phase>
    </medium>
    <medium type="heterogeneous" id="smoke">
        <volume name="density" type="gridvolume"><string name="filename" value="density.vol"/></volume>
        <volume name="albedo" type="gridvolume"><string name="filename" value="albedo.vol"/></volume>
        <float name="scale" value="3"/>
        <phase type="isotropic"/>
    </medium>
    <medium type="heterogeneous" id="haze">
        <volume name="albedo" type="constvolume"><rgb name="value" value="0.8 0.7 0.6"/></volume>
        <volume name="density" type="constvolume"><float name="value" value="0.5"/></volume>
    </medium>
    <sensor type="perspective">
        <float name="fov" value="40"/>
        <transform name="toWorld">
            <lookAt origin="0, 1, -6" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent"><integer name="sampleCount" value="$spp"/></sampler>
        <film type="hdrfilm">
            <integer name="width" value="12"/><integer name="height" value="10"/>
            <string name="filename" value="every.exr"/>
            <rfilter type="gaussian"><float name="stddev" value="0.4"/></rfilter>
        </film>
        <ref id="fog"/>
    </sensor>
    <texture type="bitmap" id="walltex">
        <string name="filename" value="wall.exr"/>
        <float name="uscale" value="2"/><float name="voffset" value="0.25"/>
    </texture>
    <texture type="checkerboard" id="checks">
        <rgb name="color0" value="0.9 0.1 0.1"/><srgb name="color1" value="#20a0ff"/>
        <float name="uvscale" value="4"/>
    </texture>
    <bsdf type="twosided" id="wall"><bsdf type="diffuse"><ref name="reflectance" id="walltex"/></bsdf></bsdf>
    <bsdf type="diffuse" id="checker"><ref name="reflectance" id="checks"/></bsdf>
    <bsdf type="roughplastic" id="rp">
        <rgb name="diffuseReflectance" value="0.3 0.4 0.5"/>
        <texture type="bitmap" name="alpha"><string name="filename" value="rough.pfm"/></texture>
        <float name="intIOR" value="1.6"/>
    </bsdf>
    <bsdf type="plastic" id="pl"><float name="alpha" value="0.04"/></bsdf>
    <bsdf type="roughdielectric" id="rd"><float name="roughness" value="0.3"/><float name="extIOR" value="1.1"/></bsdf>
    <bsdf type="dielectric" id="di"/>
    <bsdf type="disneydiffuse" id="dd"><float name="subsurface" value="0.5"/></bsdf>
    <bsdf type="disneymetal" id="dm"><float name="anisotropic" value="0.4"/></bsdf>
    <bsdf type="disneyglass" id="dg"><float name="eta" value="1.4"/></bsdf>
    <bsdf type="disneyclearcoat" id="dc"><float name="clearcoatGloss" value="0.6"/></bsdf>
    <bsdf type="disneysheen" id="ds"><float name="sheenTint" value="0.7"/></bsdf>
    <bsdf type="principled" id="pr">
        <ref name="baseColor" id="checks"/><float name="metallic" value="0.3"/>
        <float name="specTrans" value="0.2"/><float name="clearcoat" value="0.5"/>
    </bsdf>
    <bsdf type="disneybsdf" id="db"><float name="sheen" value="0.2"/></bsdf>
    <bsdf type="null" id="boundary"/>
    <shape type="obj">
        <string name="filename" value="quad.obj"/>
        <transform name="toWorld"><scale x="3" y="2"/><rotate y="1" angle="30"/><translate z="2"/></transform>
        <ref id="wall"/>
    </shape>
    <shape type="obj"><string name="filename" value="tri.obj"/><ref id="checker"/></shape>
    <shape type="obj">
        <string name="filename" value="tri.obj"/><boolean name="faceNormals" value="true"/><ref id="rp"/>
    </shape>
    <shape type="ply"><string name="filename" value="ascii.ply"/><ref id="pl"/></shape>
    <shape type="ply">
        <string name="filename" value="ico.ply"/>
        <transform name="toWorld"><matrix value="1 0 0 1.5  0 1 0 0  0 0 1 0.5  0 0 0 1"/></transform>
        <ref id="rd"/><ref name="interior" id="smoke"/><ref name="exterior" id="fog"/>
    </shape>
    <shape type="serialized">
        <string name="filename" value="meshes.serialized"/><integer name="shapeIndex" value="1"/>
        <ref id="di"/>
    </shape>
    <shape type="serialized"><string name="filename" value="meshes.serialized"/><ref id="dd"/></shape>
    <shape type="rectangle">
        <boolean name="flipNormals" value="true"/>
        <transform name="toWorld"><scale value="4"/><translate y="-1"/></transform>
        <ref id="dm"/>
    </shape>
    <shape type="sphere">
        <point name="center" x="-1.5" y="0" z="0"/><float name="radius" value="0.5"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.2"/></bsdf>
        <emitter type="area"><spectrum name="radiance" value="400:1, 500:8, 600:15.6, 700:18.4"/></emitter>
    </shape>
    <shape type="sphere"><float name="radius" value="0.3"/><ref id="dg"/></shape>
    <shape type="sphere"><point name="center" x="0" y="2" z="0"/><ref id="dc"/></shape>
    <shape type="sphere"><point name="center" x="2" y="2" z="0"/><ref id="ds"/></shape>
    <shape type="sphere"><point name="center" x="-2" y="2" z="0"/><ref id="pr"/></shape>
    <shape type="sphere"><point name="center" x="0" y="-2" z="0"/><ref id="db"/></shape>
    <shape type="sphere">
        <point name="center" x="0" y="0" z="3"/><float name="radius" value="1.2"/>
        <ref id="boundary"/><ref name="interior" id="haze"/>
    </shape>
    <emitter type="envmap">
        <string name="filename" value="env.exr"/><float name="scale" value="0.5"/>
        <transform name="toWorld"><rotate y="1" angle="90"/></transform>
    </emitter>
    <emitter type="point">
        <point name="position" x="0" y="3" z="-1"/><rgb name="intensity" value="5 5 5"/>
    </emitter>
    <emitter type="directional">
        <vector name="direction" x="0.2" y="-1" z="0.3"/><rgb name="irradiance" value="2 2 1"/>
    </emitter>
    """


@pytest.mark.parametrize("force_bvh", [False, True])
def test_every_kind(tmp_path, force_bvh, monkeypatch):
    """Every bsdf, shape, emitter, medium, texture and transform kind the
    parser knows, with meshes, grids and images written beside the XML.
    The BVH of force_bvh is both packages' numpy builder's, equal array
    for array (their native builders are held valid, not equal:
    tests/test_torch_bvh.py)."""
    from gdpt_tpu.scene import build as jbuild
    from gdpt_tpu_torch.scene import build as tbuild

    from test_torch_bvh import _reference_numpy

    build_bvh = tbuild.gbvh.build_bvh
    monkeypatch.setattr(tbuild.gbvh, "build_bvh",
                        lambda *a, builder=None: build_bvh(*a, builder="numpy"))
    monkeypatch.setattr(jbuild.gbvh, "build_bvh", _reference_numpy)
    _assets(tmp_path)
    js, ts = assert_same_parse(_write_scene(tmp_path, EVERY_KIND), force_bvh=force_bvh)
    st = ts.static
    # 13 declared, one inline, one each for the point and directional lights
    assert st.n_materials == 16 and st.n_lights == 4 and st.has_envmap
    assert st.media_is_hetero == (False, True, True)
    assert st.use_brute_force is not force_bvh


def test_integrator_names(tmp_path):
    for itype, name in (("shadingNormal", "shading_normal"), ("meanCurvature", "mean_curvature"),
                        ("rayDifferential", "ray_differential"), ("mipmapLevel", "mipmap_level"),
                        ("depth", "depth"), ("gradpath", "gradpath")):
        body = MINIMAL.replace('<integrator type="path">', f'<integrator type="{itype}">')
        _, ts = assert_same_parse(_write_scene(tmp_path, body))
        assert ts.static.options.integrator == name


def test_obj_negative_indices_and_polygons(tmp_path):
    f = tmp_path / "quad.obj"
    f.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf -4 -3 -2 -1\n")
    got, want = tloaders.load_obj(str(f)), jloaders.load_obj(str(f))
    assert len(got[0]) == 4 and len(got[1]) == 2  # fan triangulation
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_vol_loader_roundtrip(tmp_path):
    data = np.random.default_rng(0).random((4, 3, 2, 1)).astype("<f4")  # (z, y, x, c)
    f = str(tmp_path / "t.vol")
    xml_writer.write_vol(f, data, (0, 0, 0), (1, 1, 1))
    loaded, p_min, p_max = tloaders.load_vol(f)
    np.testing.assert_array_equal(loaded, data)
    np.testing.assert_array_equal(p_max, [1, 1, 1])
    for a, b in zip((loaded, p_min, p_max), jloaders.load_vol(f)):
        np.testing.assert_array_equal(a, b)


WRITTEN = {
    "cbox": lambda: tpresets.cornell_box_parts(16, 16, 2, "path", 3),
    "icosphere box": lambda: tpresets.icosphere_box_parts(
        16, 16, 2, balls=[(2, (368.0, 100.0, 351.0), 100.0)], spheres=[((186.0, 60.0, 169.0), 60.0)]),
    "volpath grid": lambda: _volpath_parts(density=tpresets.medium_grid(8, 3, 0.8),
                                           albedo=tpresets.albedo_grid(8, 4)),
    "volpath null boundary": lambda: _volpath_parts(
        null_boundary=True, density=tpresets.medium_grid(8, 3, 1.5),
        albedo=np.array([0.9, 0.7, 0.8]), g=-0.4),
    "volpath homogeneous": lambda: _volpath_parts(),
}


def _volpath_parts(**kw):
    """volpath_scene's description: build_volpath_scene with a stand-in
    for the build module that returns build_scene's arguments."""
    import types

    from gdpt_tpu_torch.core import transform as xf
    from gdpt_tpu_torch.scene import model as M

    record = types.SimpleNamespace(build_scene=lambda *a, **k: (a, k))
    (camera, materials, shapes, lights, media), k = tpresets.build_volpath_scene(
        M, record, xf, 6, 16, 16, 2, 4, with_diffuse_sphere=True, g=kw.pop("g", 0.6), **kw)
    return dict(camera=camera, materials=materials, shapes=shapes, lights=lights, media=media,
                options=k["options"])


@pytest.mark.parametrize("name", sorted(WRITTEN))
def test_written_preset_is_the_preset(tmp_path, name):
    """scene/xml_writer's file of a preset's description parses to the
    scene build_scene makes of it, leaf for leaf and bit for bit; the
    brute-force ones parse so in both packages."""
    from gdpt_tpu_torch.scene import build as tbuild

    parts = WRITTEN[name]()
    path = xml_writer.write_scene(str(tmp_path), **parts)
    own = tbuild.build_scene(**parts)
    got = assert_same_parse(path)[1] if own.static.use_brute_force else tparser.parse_scene(path)[0]
    assert got.static == own.static
    for i, (a, b) in enumerate(zip(convert.tree_leaves(got.device),
                                   convert.tree_leaves(own.device), strict=True)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f"leaf {i}"


def test_writer_refuses_what_it_cannot_write(tmp_path):
    from gdpt_tpu_torch.scene import model as M

    parts = tpresets.cornell_box_parts(8, 8, 1)
    with pytest.raises(ValueError, match="Lambertian"):
        xml_writer.write_scene(str(tmp_path), **dict(parts, materials=[M.RoughPlastic()] * 4))
    with pytest.raises(ValueError, match="area lights"):
        xml_writer.write_scene(str(tmp_path), **dict(parts, lights=[M.Envmap()]))
    with pytest.raises(ValueError, match="parse_scene"):
        xml_writer.write_scene(str(tmp_path), **parts, force_bvh=True)


@pytest.mark.parametrize("force_bvh", [False, True])
def test_parsed_file_renders_as_the_reference(tmp_path, force_bvh):
    """One parsed file, brute force and BVH, rendered by both packages: at
    least 99% of values within rtol 1e-3 / atol 1e-4, mean within 0.1%."""
    path = xml_writer.write_scene(str(tmp_path), **tpresets.cornell_box_parts(16, 16, 2, "path", 3))
    js, _ = jparser.parse_scene(path, force_bvh=force_bvh)
    ts, _ = tparser.parse_scene(path, force_bvh=force_bvh)
    assert ts.static.use_brute_force is not force_bvh
    ref = np.asarray(jpath.render_soa(js, seed=3))
    got = trender.render(ts, seed=3, device="cpu")
    assert np.isclose(got, ref, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(float(got.mean()) - float(ref.mean())) <= 1e-3 * float(ref.mean())


@pytest.mark.skipif(not HAS_REF, reason="reference scenes not mounted")
def test_parses_all_reference_scenes():
    scene_files = [
        "cbox/cbox_old.xml", "cbox/cbox_gdpt.xml", "veach_mi/mi.xml",
        "disney_bsdf_test/simple_sphere.xml", "disney_bsdf_test/disney_bsdf.xml",
        "pixel_filter_test/pixel_filter_test.xml", "matpreview/matpreview.xml",
    ] + [f"volpath_test/volpath_test{i}.xml" for i in range(1, 7)]
    for f in scene_files:
        assert_same_parse(os.path.join(REF, f))


@pytest.mark.skipif(not HAS_REF, reason="reference scenes not mounted")
def test_piz_envmap_decodes():
    path = os.path.join(REF, "matpreview/envmap.exr")
    img = timage.read_exr(path)
    assert img.shape[2] == 3 and np.isfinite(img).all()
    assert 0 < img.mean() < 10 and img.max() > 5
    np.testing.assert_array_equal(img, jimage.read_exr(path))


@pytest.mark.skipif(not HAS_REF, reason="reference scenes not mounted")
def test_obj_loader_cbox_floor():
    p, i, n, uv = tloaders.load_obj(os.path.join(REF, "cbox/meshes/cbox_floor.obj"))
    assert len(i) >= 2 and np.isfinite(p).all()
    assert np.abs(p[:, 1]).max() < 1e-3


@pytest.mark.skipif(not HAS_REF, reason="reference scenes not mounted")
def test_serialized_loader():
    p, i, n, uv = tloaders.load_serialized(
        os.path.join(REF, "matpreview/matpreview.serialized"), 1)
    assert len(p) > 1000 and len(i) > 1000
    assert np.isfinite(p).all() and int(i.max()) < len(p)
