"""A scene description (benchmark/scenes/*.py) as the reference's arrays.

Everything is worked out here from the description: the triangles
(geometry.Geometry), the camera's matrices, the light's sampling tables
and power, and the ray epsilons from the scene's bounding sphere. float64 on the host, then `dtype` on `device`.
It draws triangle meshes with Lambertian materials (RGB triples) only, and
raises ValueError naming any other entry: a sphere, or a material given
as a dict (benchmark/scenes/xml_writer.py's disneymetal and
roughdielectric). A config of such a scene names a check of its own
(`check.module`).
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import geometry

LUMA = (0.212671, 0.715160, 0.072169)
HARD_BOUNCE_CAP = 64  # path: bounces of an unbounded depth


class RefScene(NamedTuple):
    width: int
    height: int
    integrator: str
    max_depth: int
    rr_depth: int
    filter_stddev: float
    sample_to_cam: torch.Tensor   # (4, 4)
    cam_to_world: torch.Tensor    # (4, 4)
    geom: geometry.Geometry
    tri_material: torch.Tensor    # (T,) int64
    tri_light: torch.Tensor       # (T,) int64, -1 where not emissive
    albedo: torch.Tensor          # (M, 3)
    light_radiance: torch.Tensor  # (L, 3)
    light_pmf: torch.Tensor       # (L,)
    light_cdf: torch.Tensor       # (L + 1,)
    light_area: torch.Tensor      # (L,)
    light_first: torch.Tensor     # (L,) int64: first triangle
    light_tri_cdf: torch.Tensor   # (L, K + 1) area cdf over its triangles
    eps: float                    # shadow and bounce rays' tnear


def _perspective(fov_deg):
    cot = 1.0 / math.tan(math.radians(fov_deg / 2.0))
    return np.array([[cot, 0, 0, 0], [0, cot, 0, 0], [0, 0, 1, -1], [0, 0, 1, 0]], np.float64)


def sample_to_camera(fov_deg, width, height):
    """Film coordinates in [0, 1]^2 to camera space (pbrt's screen window
    [-1, 1] x [-1/aspect, 1/aspect], x flipped as lajolla's camera)."""
    aspect = width / height
    scale = np.diag([-0.5, -0.5 * aspect, 1.0, 1.0])
    shift = np.eye(4)
    shift[:3, 3] = (-1.0, -1.0 / aspect, 0.0)
    return np.linalg.inv(scale @ shift @ _perspective(fov_deg))


def _refuse_what_it_cannot_draw(desc):
    for k, m in enumerate(desc["materials"]):
        a = None if isinstance(m, dict) else np.asarray(m)
        if a is None or a.shape != (3,) or not np.issubdtype(a.dtype, np.number):
            raise ValueError(f"the reference draws Lambertian materials only; material {k} "
                             f"is {m!r}")
    for k, s in enumerate(desc["shapes"]):
        if "positions" not in s:
            raise ValueError(f"the reference draws triangle meshes only; shape {k} has keys "
                             f"{sorted(s)}")


def build(desc, device="cpu", dtype=torch.float32):
    _refuse_what_it_cannot_draw(desc)
    cam, opts = desc["camera"], desc["options"]
    pos, tri_mat, tri_light, light_tris, light_rgb = [], [], [], [], []
    for s in desc["shapes"]:
        p = np.asarray(s["positions"], np.float64)[np.asarray(s["indices"], np.int64)]
        lid = -1
        if s["emitter"] is not None:
            lid = len(light_rgb)
            light_rgb.append(np.asarray(s["emitter"], np.float64))
            light_tris.append((sum(len(q) for q in pos), p))
        pos.append(p)
        tri_mat.append(np.full(len(p), s["material"], np.int64))
        tri_light.append(np.full(len(p), lid, np.int64))
    tris = np.concatenate(pos)                          # (T, 3, 3)
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    eps = min(float(np.linalg.norm(hi - lo) / 2.0) * 1e-5, 0.01)

    n_l = len(light_rgb)
    k = max([len(p) for _, p in light_tris] + [1])
    tri_cdf = np.tile(np.linspace(0, 1, k + 1, dtype=np.float32), (max(n_l, 1), 1))
    first = np.zeros(max(n_l, 1), np.int64)
    area = np.zeros(max(n_l, 1))
    power = np.ones(max(n_l, 1))
    for li, (start, p) in enumerate(light_tris):
        a = 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1)
        cdf = np.concatenate([[0.0], np.cumsum(a)]) / max(a.sum(), 1e-30)
        tri_cdf[li, :len(cdf)] = cdf
        tri_cdf[li, len(cdf):] = 1.0
        first[li], area[li] = start, a.sum()
        rgb = light_rgb[li].astype(np.float32).astype(np.float64)
        power[li] = float(np.dot(rgb, LUMA)) * area[li] * np.pi
    pmf = power / power.sum()
    cdf = np.concatenate([[0.0], np.cumsum(power)]) / power.sum()
    cdf[-1] = 1.0

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return RefScene(
        width=int(cam["width"]), height=int(cam["height"]),
        integrator=opts["integrator"], max_depth=int(opts["max_depth"]),
        rr_depth=int(opts["rr_depth"]), filter_stddev=float(cam["filter_param"]),
        sample_to_cam=t(sample_to_camera(cam["fov"], cam["width"], cam["height"])
                        .astype(np.float32)),
        cam_to_world=t(np.asarray(cam["cam_to_world"], np.float64).astype(np.float32)),
        geom=geometry.Geometry.build(tris, device, dtype),
        tri_material=t(np.concatenate(tri_mat), torch.int64),
        tri_light=t(np.concatenate(tri_light), torch.int64),
        albedo=t(np.asarray(desc["materials"], np.float64).astype(np.float32)),
        light_radiance=t(np.asarray(light_rgb or [[0.0] * 3], np.float64).astype(np.float32)),
        light_pmf=t(pmf.astype(np.float32)), light_cdf=t(cdf.astype(np.float32)),
        light_area=t(area.astype(np.float32)), light_first=t(first, torch.int64),
        light_tri_cdf=t(tri_cdf), eps=eps)
