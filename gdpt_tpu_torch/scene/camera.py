"""Pinhole perspective camera matrices (reference: src/camera.h/.cpp).

Counterpart of gdpt_tpu/scene/camera.py: the host builds the
sample<->camera<->world matrices in float64; the batched primary-ray
generator lives in integrators/path_soa.py.
"""

from typing import NamedTuple

import torch

from gdpt_tpu_torch.core import transform as xf
from gdpt_tpu_torch.core.dtypes import REAL, asarray


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
