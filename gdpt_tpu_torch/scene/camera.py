"""Pinhole perspective camera matrices (reference: src/camera.h/.cpp).

Counterpart of gdpt_tpu/scene/camera.py: the host builds the
sample<->camera<->world matrices in float64. The SoA renders' primary
rays are integrators/path_soa.py's; sample_primary and the
ray-differential helpers serve the per-ray integrators, with the
reference's vmap axis as the leading dimension.
"""

from typing import NamedTuple

import torch

from gdpt_tpu_torch.core import math as gm
from gdpt_tpu_torch.core import transform as xf
from gdpt_tpu_torch.core.dtypes import REAL, asarray
from gdpt_tpu_torch.scene import filters


class CameraArrays(NamedTuple):
    sample_to_cam: torch.Tensor  # (4, 4)
    cam_to_world: torch.Tensor   # (4, 4)
    world_to_cam: torch.Tensor   # (4, 4)


def make_camera_arrays(cam_to_world, fov_deg, width, height):
    aspect = width / height
    cam_to_sample = (
        xf.scale([-0.5, -0.5 * aspect, 1.0])
        @ xf.translate([-1.0, -1.0 / aspect, 0.0])
        @ xf.perspective(fov_deg)
    )
    sample_to_cam = xf.inverse(cam_to_sample)
    return CameraArrays(
        asarray(sample_to_cam, REAL),
        asarray(cam_to_world, REAL),
        asarray(xf.inverse(cam_to_world), REAL),
    )


def _xform_point(m, p):
    """Rows p (N, 3) through the 4x4 m, with the perspective divide."""
    q = gm.apply3(m[:3, :3], p) + m[:3, 3]
    w = gm.apply3(m[3:4, :3], p)[:, 0] + m[3, 3]
    return q / w[:, None]


def sample_primary(cam: CameraArrays, width, height, filter_kind, filter_param, screen_pos):
    """Primary rays (org, dir), each (N, 3), for screen positions (N, 2)
    in [0,1]^2; the fractional pixel position is re-warped through the
    reconstruction filter placed at the pixel center (reference:
    src/camera.cpp:29-41; gdpt_tpu/scene/camera.py:sample_primary)."""
    size = torch.tensor([width, height], dtype=REAL, device=screen_pos.device)
    pixel = screen_pos * size
    frac = pixel - torch.floor(pixel)
    offset = filters.sample_filter(filter_kind, filter_param, frac)
    remapped = (torch.floor(pixel) + 0.5 + offset) / size
    pt = _xform_point(cam.sample_to_cam, torch.cat(
        [remapped, torch.zeros_like(remapped[:, :1])], dim=1))
    d_cam = pt / torch.sqrt((pt * pt).sum(-1, keepdim=True))
    org = cam.cam_to_world[:3, 3].expand(pt.shape)
    d = gm.apply3(cam.cam_to_world[:3, :3], d_cam)
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    return org, d


def init_ray_differential(width, height):
    """radius = 0, spread = 0.25 / max(w, h) (reference: src/ray.h:36-38),
    as f32 0-d tensors."""
    return torch.tensor(0.0, dtype=REAL), torch.tensor(0.25 / max(width, height), dtype=REAL)


def ray_diff_transfer(radius, spread, dist):
    return radius + spread * dist


def ray_diff_reflect(radius, spread, mean_curvature, roughness):
    spec = spread + 2.0 * mean_curvature * radius
    return torch.clamp_min(spec * (1.0 - roughness) + 0.2 * roughness, 0.0)


def ray_diff_refract(radius, spread, mean_curvature, eta, roughness):
    spec = (spread + 2.0 * mean_curvature * radius) / eta
    return torch.clamp_min(spec * (1.0 - roughness) + 0.2 * roughness, 0.0)
