"""Built-in test scenes, counterpart of gdpt_tpu/scene/presets.py.

`cornell_box` reproduces the classic Cornell-box configuration the
reference renders via scenes/cbox/cbox.xml (512x512, gaussian filter,
lookAt (278,273,-800) -> (278,273,-799), fov 39.3077): the published
Cornell geometry with the reference's spectral reflectance / emission
converted through the same CIE pipeline.

`icosphere_box` is the port's own large scene, built in code: the same
box with its blocks replaced by finely subdivided icospheres, so the
BVH path can be driven at a real size without a scene file.

`material_box` is the port's shading test scene: the Cornell walls,
light and camera with every material kind, spectrum and float image
textures and an image envmap. `furnace_sphere` is the reference's
furnace test under a constant envmap.

`volpath_scene` is the reference's volumetric test family;
`build_volpath_scene` builds it with either package's modules, with a
density grid of the caller's (`medium_grid`) and a null-material
boundary as options. `medium_box` is the icosphere box with its room
filled by a heterogeneous medium inside a null-material box.
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
    return build.build_scene(**cornell_box_parts(width, height, spp, integrator, max_depth),
                             force_bvh=force_bvh)


def cornell_box_parts(width=512, height=512, spp=4, integrator="path", max_depth=-1):
    """cornell_box's description: build.build_scene's arguments as a dict
    (scene/xml_writer.write_scene takes the same)."""
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
    return dict(camera=cam, materials=materials, shapes=shapes, lights=lights, options=opts)


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
    return build.build_scene(**icosphere_box_parts(width, height, spp, balls, spheres,
                                                   max_depth, integrator))


def icosphere_box_parts(width, height, spp, balls=None, spheres=(), max_depth=-1,
                        integrator="path"):
    """icosphere_box's description, as cornell_box_parts."""
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
    return dict(camera=cam, materials=materials, shapes=shapes, lights=lights, options=opts)


def medium_grid(res, seed, mean=1.0, floor=0.2, tint=True):
    """A (res, res, res, 3) grid made with numpy from `seed`: a value per
    cell, floor + (1 - floor) * u^3 for a uniform u (so the max is several
    times the mean, and delta tracking takes null collisions), each
    channel scaled by its own tint when `tint`, the whole scaled to
    `mean`."""
    rng = np.random.default_rng(seed)
    grid = floor + (1.0 - floor) * rng.random((res, res, res, 1)) ** 3
    if tint:
        grid = grid * rng.uniform(0.4, 1.0, 3) * (1.0 + 0.3 * rng.random((res, res, res, 3)))
    else:
        grid = np.repeat(grid, 3, axis=-1)
    return (grid * (mean / grid.mean())).astype(np.float32)


def albedo_grid(res, seed):
    """A chromatic (res, res, res, 3) albedo grid in [0.3, 0.95] made
    with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    return (0.3 + 0.65 * rng.random((res, res, res, 3))).astype(np.float32)


def build_volpath_scene(M, build, xf, version=1, width=48, height=48, spp=16, max_depth=-1,
                        sigma_a=(0.1, 0.1, 0.1), sigma_s=(0.7, 0.7, 0.7), g=0.0,
                        hetero=False, grid_res=None, with_diffuse_sphere=False,
                        force_bvh=False, density=None, albedo=None, null_boundary=False):
    """volpath_scene with the model, build and transform modules given:
    a package's own, so that a test builds the same scene with either
    package. density: a (Z, Y, X, 3) grid that takes the place of the
    constant one (hetero then implied), albedo a grid or an rgb constant
    beside it. null_boundary: the medium fills a sphere of material -1
    (radius 1.45, around the first light); the camera, the second light
    and the diffuse sphere are outside it, in vacuum, and the grid's
    bbox is the sphere's."""
    if g == 0.0:
        phase = M.IsotropicPhase()
    else:
        phase = M.HenyeyGreenstein(g=g)
    half = 1.5 if null_boundary else 50.0
    if hetero or density is not None:
        res = grid_res or 1
        sa, ss = np.asarray(sigma_a), np.asarray(sigma_s)
        if density is None:
            density = np.full((res, res, res, 3), sa + ss, np.float32)
        if albedo is None:
            albedo = np.full((res, res, res, 3), ss / (sa + ss), np.float32)
        box = dict(p_min=np.full(3, -half), p_max=np.full(3, half))
        medium = M.HeterogeneousMedium(
            albedo=(M.GridVolume(albedo, **box) if np.ndim(albedo) == 4
                    else np.asarray(albedo, np.float64)),
            density=M.GridVolume(density, **box),
            phase=phase,
        )
    else:
        medium = M.HomogeneousMedium(
            sigma_a=np.asarray(sigma_a), sigma_s=np.asarray(sigma_s), phase=phase
        )

    outer = -1 if null_boundary else 0
    materials = [M.Lambertian(np.zeros(3)), M.Lambertian(np.full(3, 0.6))]
    shapes = [
        M.Sphere(center=np.array([0.0, 0.0, 0.0]), radius=1.0,
                 material_id=0, area_light_id=0, exterior_medium_id=0),
        M.Sphere(center=np.array([-3.0, 0.0, -1.5]), radius=1.0,
                 material_id=0, area_light_id=1, exterior_medium_id=outer),
    ]
    lights = [
        M.DiffuseAreaLight(0, np.array([0.4, 2.32, 3.2])),
        M.DiffuseAreaLight(1, np.array([24.0, 10.0, 24.0])),
    ]
    if with_diffuse_sphere:
        shapes.append(
            M.Sphere(center=np.array([2.5, 0.0, 0.5]), radius=1.0,
                     material_id=1, exterior_medium_id=outer)
        )
    if null_boundary:
        shapes.append(M.Sphere(center=np.zeros(3), radius=1.45, material_id=-1,
                               interior_medium_id=0, exterior_medium_id=-1))
    cam = M.Camera(
        cam_to_world=xf.look_at([0, 0, -3], [0, 0, 0], [0, 1, 0]),
        fov=45.0,
        width=width,
        height=height,
        filter_kind=FILTER_GAUSSIAN,
        filter_param=0.5,
        medium_id=outer,
    )
    opts = M.RenderOptions(
        integrator="volpath", samples_per_pixel=spp, max_depth=max_depth,
        vol_path_version=version,
    )
    return build.build_scene(cam, materials, shapes, lights, [medium],
                             options=opts, force_bvh=force_bvh)


def volpath_scene(version=1, width=48, height=48, spp=16, max_depth=-1,
                  sigma_a=(0.1, 0.1, 0.1), sigma_s=(0.7, 0.7, 0.7), g=0.0,
                  hetero=False, grid_res=None, with_diffuse_sphere=False,
                  force_bvh=False, **kw):
    """Volumetric test scene family mirroring scenes/volpath_test/*.xml:
    emissive spheres inside a global homogeneous (or grid) medium, camera
    immersed in the medium. Keywords of build_volpath_scene (density,
    albedo, null_boundary) pass through."""
    return build_volpath_scene(M, build, xf, version, width, height, spp, max_depth, sigma_a,
                               sigma_s, g, hetero, grid_res, with_diffuse_sphere, force_bvh,
                               **kw)


# The medium box's null boundary: inside the walls, under the light.
MEDIUM_BOX_MIN = (1.0, 1.0, 1.0)
MEDIUM_BOX_MAX = (548.0, 547.0, 558.0)


def _box_mesh(M, lo, hi, **kw):
    """A closed axis-aligned box of 12 triangles, every geometric normal
    (cross(p1 - p0, p2 - p0)) pointing out: corner k has bit i of k set
    where its coordinate i is hi's, and the faces -z, +z, -y, +y, -x, +x
    run counterclockwise seen from outside."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    corners = np.array([[hi[i] if (k >> i) & 1 else lo[i] for i in range(3)]
                        for k in range(8)])
    faces = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
    idx = np.array([t for a, b, c, d in faces for t in ((a, b, c), (a, c, d))], np.int64)
    return M.TriangleMesh(positions=corners, indices=idx, **kw)


def build_medium_box(M, build, xf, width, height, spp, balls=None, grid_res=64, seed=0,
                     mean_density=0.004, g=0.5, max_depth=-1, version=6):
    """The icosphere box of icosphere_box (walls, ceiling light, camera,
    Lambertian materials) as a volpath scene, with the model, build and
    transform modules given: the room is filled with a heterogeneous
    medium (density medium_grid(grid_res, seed, mean_density), a
    chromatic albedo grid, HG phase g) inside a closed box of material
    -1 just inside the walls (MEDIUM_BOX_MIN, MEDIUM_BOX_MAX), whose
    bounds are the grid's. The camera looks in from outside, in vacuum;
    the balls (ICOSPHERE_BALLS when None) stand in the medium. Always
    the BVH path."""
    balls = ICOSPHERE_BALLS if balls is None else balls

    def quads(qs, **kw):
        pos, idx = zip(*(_quad(*q) for q in qs))
        idx = [i + 4 * k for k, i in enumerate(idx)]
        return M.TriangleMesh(positions=np.concatenate(pos), indices=np.concatenate(idx), **kw)

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
        _box_mesh(M, MEDIUM_BOX_MIN, MEDIUM_BOX_MAX, material_id=-1, interior_medium_id=0,
                  exterior_medium_id=-1),
    ]
    for level, center, radius in balls:
        pos, idx = icosphere(level, center, radius)
        shapes.append(M.TriangleMesh(positions=pos, indices=idx, material_id=0,
                                     exterior_medium_id=0))
    shapes.append(quads([((343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332),
                          (213, 548.7, 227))], material_id=3, area_light_id=0))
    lights = [M.DiffuseAreaLight(shape_id=len(shapes) - 1, intensity=LIGHT_RGB)]
    box = dict(p_min=np.asarray(MEDIUM_BOX_MIN), p_max=np.asarray(MEDIUM_BOX_MAX))
    medium = M.HeterogeneousMedium(
        albedo=M.GridVolume(albedo_grid(grid_res, seed + 1), **box),
        density=M.GridVolume(medium_grid(grid_res, seed, mean_density), **box),
        phase=M.HenyeyGreenstein(g=g))
    cam = M.Camera(cam_to_world=xf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
                   fov=39.3077, width=width, height=height,
                   filter_kind=FILTER_GAUSSIAN, filter_param=0.5)
    opts = M.RenderOptions(integrator="volpath", samples_per_pixel=spp, max_depth=max_depth,
                           vol_path_version=version)
    return build.build_scene(cam, materials, shapes, lights, [medium], options=opts,
                             force_bvh=True)


def medium_box(width, height, spp, **kw):
    """build_medium_box with this package's modules."""
    return build_medium_box(M, build, xf, width, height, spp, **kw)


def furnace_sphere(albedo=1.0, emission=1.0, width=64, height=64, spp=16,
                   max_depth=-1):
    """Furnace test: a Lambertian sphere under a constant environment map.

    Analytic solution: pixels on the (convex) sphere converge to
    albedo * emission; pixels that miss it see the envmap directly.
    Exercises NEE + BSDF MIS against the envmap in one scene.
    """
    materials = [M.Lambertian(np.full(3, albedo))]
    inner = M.Sphere(center=np.zeros(3), radius=1.0, material_id=0)
    lights = [M.Envmap(texture=np.full(3, emission))]
    cam = M.Camera(
        cam_to_world=xf.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0]),
        fov=45.0,
        width=width,
        height=height,
    )
    opts = M.RenderOptions(integrator="path", samples_per_pixel=spp, max_depth=max_depth)
    return build.build_scene(cam, materials, [inner], lights, options=opts)


def material_box_images(image_px, env_px, seed):
    """The material box's images, made with numpy from `seed`: the back
    wall's (image_px, image_px, 3) colour image, the floor's
    (image_px, image_px) roughness map and the (env_px, 2 env_px, 3)
    envmap, which has a bright patch and black rows (zero-pdf runs)."""
    rng = np.random.default_rng(seed)
    t = (np.arange(image_px) + 0.5) / image_px
    wave = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)[:, None] * np.cos(2 * np.pi * 2 * t)[None]
    wall = (0.15 + 0.6 * wave[..., None] * rng.uniform(0.5, 1.0, 3)
            + 0.1 * rng.random((image_px, image_px, 3)))
    rough = 0.05 + 0.6 * wave.T * rng.uniform(0.7, 1.0) + 0.1 * rng.random((image_px, image_px))
    ey = (np.arange(env_px) + 0.5) / env_px
    ex = (np.arange(2 * env_px) + 0.5) / (2 * env_px)
    sky = (0.3 + 0.7 * (1.0 - ey))[:, None, None] * np.array([0.5, 0.7, 1.0])
    env = np.broadcast_to(sky, (env_px, 2 * env_px, 3)) * (
        0.8 + 0.4 * rng.random((env_px, 2 * env_px, 1)))
    sun = np.exp(-(((ey - 0.3)[:, None] / 0.06) ** 2 + ((ex - 0.6)[None] / 0.04) ** 2))
    env = env + 20.0 * sun[..., None] * np.array([1.0, 0.9, 0.7])
    env[int(env_px * 0.8):] = 0.0  # black below the horizon band
    return (wall.astype(np.float32), rough.astype(np.float32), env.astype(np.float32))


# Analytic spheres of the material box: (center, radius, material id).
# One per remaining material kind (ids 6-12), then one with the wall's
# image (id 0) and one with the floor's roughness map (id 5): nine, so
# that on the BVH path they ride in the packet table (more than
# traverse_soa.SPH_BRUTE_MAX).
MATERIAL_SPHERES = [((90.0, 45.0, 420.0), 45.0, 6), ((470.0, 45.0, 130.0), 45.0, 7),
                    ((100.0, 250.0, 300.0), 45.0, 8), ((460.0, 300.0, 150.0), 50.0, 9),
                    ((278.0, 330.0, 450.0), 45.0, 10), ((200.0, 420.0, 250.0), 45.0, 11),
                    ((330.0, 300.0, 300.0), 60.0, 12), ((440.0, 470.0, 420.0), 40.0, 0),
                    ((150.0, 120.0, 60.0), 35.0, 5)]


def build_material_box(M, build, xf, width, height, spp, bvh=False, integrator="path",
                       image_px=64, env_px=32, seed=0, max_depth=-1, balls=None):
    """material_box with the model, build and transform modules given:
    a package's own, so that a test builds the same box with either
    package."""
    wall_img, rough_img, env_img = material_box_images(image_px, env_px, seed)

    def uv_quad(p0, p1, p2, p3, **kw):
        pos, idx = _quad(p0, p1, p2, p3)
        uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
        return M.TriangleMesh(positions=pos, indices=idx, uvs=uvs, **kw)

    def plain_quad(p0, p1, p2, p3, **kw):
        pos, idx = _quad(p0, p1, p2, p3)
        return M.TriangleMesh(positions=pos, indices=idx, **kw)

    materials = [
        M.Lambertian(M.ImageTexture(wall_img, name="wall", uscale=2.0, vscale=2.0)),
        M.Lambertian(RED),
        M.Lambertian(GREEN),
        M.Lambertian(np.array([0.78, 0.78, 0.78])),
        M.Lambertian(WHITE),
        M.RoughPlastic(diffuse_reflectance=WHITE, specular_reflectance=0.9,
                       roughness=M.ImageTexture(rough_img, name="floor_roughness"), eta=1.5),
        M.RoughDielectric(specular_reflectance=1.0, specular_transmittance=0.95,
                          roughness=0.15, eta=1.5),
        M.DisneyDiffuse(base_color=np.array([0.8, 0.5, 0.3]), roughness=0.6, subsurface=0.4),
        M.DisneyMetal(base_color=np.array([0.9, 0.7, 0.4]), roughness=0.3, anisotropic=0.5),
        M.DisneyGlass(base_color=np.array([0.85, 0.95, 0.9]), roughness=0.2,
                      anisotropic=0.3, eta=1.45),
        M.DisneyClearcoat(clearcoat_gloss=0.7),
        M.DisneySheen(base_color=np.array([0.3, 0.4, 0.8]), sheen_tint=0.6),
        M.DisneyBSDF(base_color=np.array([0.6, 0.3, 0.5]), specular_transmission=0.4,
                     metallic=0.3, subsurface=0.2, specular=0.5, roughness=0.35,
                     specular_tint=0.3, anisotropic=0.2, sheen=0.5, sheen_tint=0.4,
                     clearcoat=0.6, clearcoat_gloss=0.8, eta=1.5),
    ]
    shapes = [
        uv_quad((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2), material_id=5),
        plain_quad((556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0),
                   material_id=4),
        uv_quad((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2),
                material_id=0),
        plain_quad((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2), material_id=2),
        plain_quad((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0),
                   material_id=1),
    ]
    for center, radius, mid in MATERIAL_SPHERES:
        shapes.append(M.Sphere(center=np.asarray(center, np.float64), radius=radius,
                               material_id=mid))
    if bvh:
        # The large ball a Disney BSDF, the small one a rough dielectric.
        for (level, center, radius), mid in zip(ICOSPHERE_BALLS if balls is None else balls,
                                                (12, 6)):
            pos, idx = icosphere(level, center, radius)
            shapes.append(M.TriangleMesh(positions=pos, indices=idx, material_id=mid))
    shapes.append(plain_quad((343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332),
                             (213, 548.7, 227), material_id=3, area_light_id=0))
    lights = [M.DiffuseAreaLight(shape_id=len(shapes) - 1, intensity=LIGHT_RGB),
              M.Envmap(texture=M.ImageTexture(env_img, name="envmap"), scale=1.0)]
    cam = M.Camera(cam_to_world=xf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
                   fov=45.0, width=width, height=height,
                   filter_kind=FILTER_GAUSSIAN, filter_param=0.5)
    opts = M.RenderOptions(integrator=integrator, samples_per_pixel=spp,
                           max_depth=max_depth)
    return build.build_scene(cam, materials, shapes, lights, options=opts, force_bvh=bvh)


def material_box(width, height, spp, bvh=False, integrator="path", image_px=64,
                 env_px=32, seed=0, max_depth=-1, balls=None):
    """The Cornell walls, ceiling light and camera (fov 45, so the
    envmap shows around the box) around one analytic sphere of each
    material kind beyond Lambertian: rough dielectric, Disney diffuse,
    metal, glass, clearcoat, sheen, and a Disney BSDF with metallic,
    clearcoat and specular transmission all nonzero. The back wall is a
    Lambertian with an (image_px, image_px) image texture, the floor a
    rough plastic whose roughness is a 1-channel image; two more spheres
    carry these two materials. An (env_px, 2 env_px) image envmap lights
    the box through its open front. Images from numpy's generator at
    `seed`.

    bvh=False: 21 primitives, the brute-force casts. bvh=True adds the
    icosphere balls of `balls` (ICOSPHERE_BALLS, 409,612 triangles, when
    None), the large one a Disney BSDF and the small one a rough
    dielectric, and takes the BVH path whatever their size, the nine
    spheres in the packet table."""
    return build_material_box(M, build, xf, width, height, spp, bvh, integrator, image_px,
                              env_px, seed, max_depth, balls)
