"""Built-in test scenes, counterpart of gdpt_tpu/scene/presets.py.

`cornell_box` reproduces the classic Cornell-box configuration the
reference renders via scenes/cbox/cbox.xml (512x512, gaussian filter,
lookAt (278,273,-800) -> (278,273,-799), fov 39.3077): the published
Cornell geometry with the reference's spectral reflectance / emission
converted through the same CIE pipeline.
"""

import numpy as np

from gdpt_tpu_torch.core import spectrum as gspec
from gdpt_tpu_torch.core import transform as xf
from gdpt_tpu_torch.scene import build
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene.filters import FILTER_GAUSSIAN


def _quad(p0, p1, p2, p3):
    pos = np.array([p0, p1, p2, p3], np.float64)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return pos, idx


def _mesh_from_quads(quads, **kw):
    pos_list, idx_list, off = [], [], 0
    for q in quads:
        p, i = _quad(*q)
        pos_list.append(p)
        idx_list.append(i + off)
        off += len(p)
    return M.TriangleMesh(
        positions=np.concatenate(pos_list),
        indices=np.concatenate(idx_list),
        **kw,
    )


# Classic Cornell-box RGB albedos.
WHITE = np.array([0.725, 0.71, 0.68])
RED = np.array([0.63, 0.065, 0.05])
GREEN = np.array([0.14, 0.45, 0.091])
# The reference's luminaire spectrum 400:0, 500:8, 600:15.6, 700:18.4
# through the integrate_XYZ -> RGB pipeline.
LIGHT_RGB = gspec.spectrum_to_rgb(
    [400.0, 500.0, 600.0, 700.0], [0.0, 8.0, 15.6, 18.4]
)


def cornell_box(
    width=512,
    height=512,
    spp=4,
    integrator="path",
    max_depth=-1,
):
    shapes = []
    # material ids: 0 white, 1 red, 2 green, 3 light-white
    materials = [
        M.Lambertian(WHITE),
        M.Lambertian(RED),
        M.Lambertian(GREEN),
        M.Lambertian(np.array([0.78, 0.78, 0.78])),
    ]
    floor = _mesh_from_quads(
        [((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2))],
        material_id=0,
    )
    ceiling = _mesh_from_quads(
        [((556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0))],
        material_id=0,
    )
    back = _mesh_from_quads(
        [((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2))],
        material_id=0,
    )
    green_wall = _mesh_from_quads(
        [((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2))],
        material_id=2,
    )
    red_wall = _mesh_from_quads(
        [((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0))],
        material_id=1,
    )
    short_block = _mesh_from_quads(
        [
            ((130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)),
            ((290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)),
            ((130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)),
            ((82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)),
            ((240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)),
        ],
        material_id=0,
    )
    tall_block = _mesh_from_quads(
        [
            ((423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)),
            ((423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)),
            ((472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)),
            ((314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)),
            ((265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)),
        ],
        material_id=0,
    )
    shapes += [floor, ceiling, back, green_wall, red_wall, short_block, tall_block]

    light_mesh = _mesh_from_quads(
        [((343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332), (213, 548.7, 227))],
        material_id=3,
        area_light_id=0,
    )
    shapes.append(light_mesh)
    lights = [M.DiffuseAreaLight(shape_id=len(shapes) - 1, intensity=LIGHT_RGB)]

    cam = M.Camera(
        cam_to_world=xf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
        fov=39.3077,
        width=width,
        height=height,
        filter_kind=FILTER_GAUSSIAN,
        filter_param=0.5,
    )
    opts = M.RenderOptions(
        integrator=integrator, samples_per_pixel=spp, max_depth=max_depth
    )
    return build.build_scene(cam, materials, shapes, lights, options=opts)
