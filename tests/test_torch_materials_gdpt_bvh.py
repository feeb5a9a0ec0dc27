"""The port's gradpath render of the BVH material box (force_bvh, two
small icosphere balls: a Disney BSDF mesh and a rough dielectric mesh;
packet table and wavefront lane pool) against gdpt_tpu's, on the CPU, at
the gates of tests/test_torch_materials_gdpt.py, whose helpers it uses;
a file of its own so that its reference render, about a minute of
compiling on this CPU, runs on a worker of its own. The gpu-marked test
holds the card's render against the CPU's, as there.
"""

import pytest

from test_torch_materials_gdpt import BUFFERS, check_buffer, check_cuda_vs_cpu, check_rays
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("name", BUFFERS)
def test_gradpath_matches_reference(name):
    check_buffer("bvh", name)


def test_gradpath_ray_count_matches_reference():
    check_rays("bvh")


@pytest.mark.gpu
def test_cuda_gradpath_matches_cpu():
    check_cuda_vs_cpu(True)
