"""Built-in test scenes, counterpart of gdpt_tpu/scene/presets.py.

`cornell_box` reproduces the classic Cornell-box configuration the
reference renders via scenes/cbox/cbox.xml (512x512, gaussian filter,
lookAt (278,273,-800) -> (278,273,-799), fov 39.3077): the published
Cornell geometry with the reference's spectral reflectance / emission
converted through the same CIE pipeline.

`icosphere_box` is the port's own large scene, built in code: the same
box with its blocks replaced by finely subdivided icospheres, so the
BVH path can be driven at a real size without a scene file.
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
    force_bvh=False,
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
    return build.build_scene(cam, materials, shapes, lights, options=opts,
                             force_bvh=force_bvh)


# The tall block's place and the short block's, resting on the floor.
ICOSPHERE_BALLS = [(7, (368.0, 100.0, 351.0), 100.0), (6, (186.0, 60.0, 169.0), 60.0)]


def icosphere(level, center, radius):
    """Unit icosahedron subdivided `level` times (20 * 4^level triangles),
    vertices pushed onto the sphere: (positions (V, 3), indices (T, 3))."""
    p = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0], [0, -1, p], [0, 1, p],
                  [0, -1, -p], [0, 1, -p], [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(level):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        ab, bc, ca = inv.reshape(3, -1) + len(v)
        v = np.concatenate([v, mid])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)])
    return v * radius + np.asarray(center, np.float64), f


def icosphere_box(width, height, spp, balls=None, spheres=(), max_depth=-1,
                  integrator="path"):
    """The Cornell box of cornell_box (walls, ceiling light,
    camera, materials) with its two blocks replaced by icospheres:
    balls = [(level, center, radius), ...]; spheres = analytic spheres
    [(center, radius), ...]. balls=None takes ICOSPHERE_BALLS (409,612
    triangles in all), the port's stand-in for a large mesh scene.
    Lambertian throughout."""
    quads = _mesh_from_quads
    balls = ICOSPHERE_BALLS if balls is None else balls
    materials = [M.Lambertian(WHITE), M.Lambertian(RED),
                 M.Lambertian(GREEN), M.Lambertian(np.array([0.78, 0.78, 0.78]))]
    shapes = [
        quads([((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2))], material_id=0),
        quads([((556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0))],
              material_id=0),
        quads([((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2))],
              material_id=0),
        quads([((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2))], material_id=2),
        quads([((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0))],
              material_id=1),
    ]
    for level, center, radius in balls:
        pos, idx = icosphere(level, center, radius)
        shapes.append(M.TriangleMesh(positions=pos, indices=idx, material_id=0))
    for center, radius in spheres:
        shapes.append(M.Sphere(center=np.asarray(center, np.float64), radius=radius,
                               material_id=0))
    shapes.append(quads([((343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332),
                          (213, 548.7, 227))], material_id=3, area_light_id=0))
    lights = [M.DiffuseAreaLight(shape_id=len(shapes) - 1, intensity=LIGHT_RGB)]
    cam = M.Camera(cam_to_world=xf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
                   fov=39.3077, width=width, height=height,
                   filter_kind=FILTER_GAUSSIAN, filter_param=0.5)
    opts = M.RenderOptions(integrator=integrator, samples_per_pixel=spp,
                           max_depth=max_depth)
    return build.build_scene(cam, materials, shapes, lights, options=opts)
