"""Scene descriptions of the Cornell-box family, as plain data.

A frozen copy of gdpt_tpu_torch/scene/presets.py's cornell_box_parts: the
published Cornell geometry (walls, blocks and ceiling light of the
classic cbox.xml), its Lambertian albedos and the luminaire's spectrum
through the CIE pipeline, here as its RGB numbers.
A description is a dict of numpy arrays and numbers that
benchmark/scenes/xml_writer.py writes as XML plus binary PLY and that
benchmark/reference/scene.py reads directly; nothing here imports the
program. The box uses the writer's mesh and RGB-triple forms only
(xml_writer.py lists the sphere, disneymetal and roughdielectric forms
too), the forms the reference draws.
"""

import numpy as np

WHITE = (0.725, 0.71, 0.68)
RED = (0.63, 0.065, 0.05)
GREEN = (0.14, 0.45, 0.091)
LIGHT_WHITE = (0.78, 0.78, 0.78)
# The luminaire's spectrum 400:0, 500:8, 600:15.6, 700:18.4 integrated to
# XYZ and taken to linear sRGB.
LIGHT_RGB = (20.62595099021261, 10.908849440218676, 2.763041520614314)

WALLS = (
    # floor, ceiling, back wall (white), green wall, red wall
    ([((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2))], 0),
    ([((556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0))], 0),
    ([((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2))], 0),
    ([((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2))], 2),
    ([((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0))], 1),
)
SHORT_BLOCK = [
    ((130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)),
    ((290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)),
    ((130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)),
    ((82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)),
    ((240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)),
]
TALL_BLOCK = [
    ((423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)),
    ((423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)),
    ((472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)),
    ((314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)),
    ((265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)),
]
LIGHT_QUAD = [((343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332), (213, 548.7, 227))]


def look_at(pos, target, up):
    """Camera-to-world matrix (float64) of a camera at pos looking at target."""
    pos, target, up = (np.asarray(a, np.float64) for a in (pos, target, up))
    d = target - pos
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, np.cross(d, left), d, pos
    return m


def quads(qs, material, emitter=None):
    """A triangle mesh of quads, each split (0, 1, 2) and (0, 2, 3)."""
    pos = np.array([p for q in qs for p in q], np.float64)
    idx = np.concatenate([np.array([[0, 1, 2], [0, 2, 3]], np.int64) + 4 * k
                          for k in range(len(qs))])
    return {"positions": pos, "indices": idx, "material": material, "emitter": emitter}


def _frame(cfg, shapes):
    return {
        "camera": {"cam_to_world": look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
                   "fov": 39.3077, "width": cfg["width"], "height": cfg["height"],
                   "filter": "gaussian", "filter_param": 0.5},
        "materials": [WHITE, RED, GREEN, LIGHT_WHITE],
        "shapes": shapes + [quads(LIGHT_QUAD, 3, emitter=LIGHT_RGB)],
        "options": {"integrator": cfg["integrator"], "spp": cfg["spp"],
                    "max_depth": cfg["max_depth"], "rr_depth": cfg["rr_depth"]},
    }


def cornell_box(cfg):
    """The classic Cornell box: five walls, the two blocks, the light."""
    shapes = [quads(q, m) for q, m in WALLS]
    shapes += [quads(SHORT_BLOCK, 0), quads(TALL_BLOCK, 0)]
    return _frame(cfg, shapes)
