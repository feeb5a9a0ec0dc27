"""The port's per-ray gradient-domain render (integrators/gdpt.py's
render_gradpath) against the committed cbox_gdpt golden and the
statistical checks of tests/test_gdpt.py, on the CPU.

The golden: tests/goldens/cbox_gdpt.exr is the reference's
gdpt.render_gradpath of the 48x48 cbox at 16 spp, depth 5, seed 42
(tests/test_goldens.py, tools/make_goldens.py). The port renders the
same and reads the golden with its own core/image.read_exr; the render
passes at tests/test_goldens.py's bound, RMSE / mean < 0.05.

tests/test_gdpt.py's four checks of the estimator (:58-117), on the
port's own images: the 48x48, 16 spp, depth-5 reconstruction (seed 4)
against a 128-spp `path` image of the same box (the port's SoA render,
seed 11): means within 10%; the reconstruction from the brute-force
primal beats that primal's RMSE by 20%; the shipped reconstruction stays
within 1.15x of the NEE primal's RMSE; the estimated x-gradients
correlate with the reference image's finite differences above 0.5.

The gpu-marked test renders the golden on the card and holds it to the
same bound; this file imports no jax, so it runs with --noconftest.
"""

import os

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.core import image as timage
from gdpt_tpu_torch.integrators import gdpt as tgdpt
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.ops import poisson
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cbox_gdpt.exr")


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def golden_ratio(device):
    """RMSE / mean of the port's cbox_gdpt render on `device` against the
    golden (tests/test_goldens.py's measure)."""
    golden = timage.read_exr(GOLDEN)
    img = tgdpt.render_gradpath(
        tpresets.cornell_box(width=48, height=48, spp=16, integrator="gradpath", max_depth=5),
        seed=42, device=device)
    assert img.shape == golden.shape == (48, 48, 3)
    ratio = _rmse(img, golden) / max(float(np.abs(golden).mean()), 1e-3)
    print(f"cbox_gdpt on {device}: RMSE / mean {ratio:.4g} (bound 0.05)")
    return ratio


def test_golden_cbox_gdpt():
    assert golden_ratio("cpu") < 0.05


@pytest.fixture(scope="module")
def gdpt_run():
    sc = tpresets.cornell_box(width=48, height=48, spp=16, integrator="gradpath", max_depth=5)
    recon, aux = tgdpt.render_gradpath(sc, seed=4, return_aux=True, device="cpu")
    ref = trender.render(tpresets.cornell_box(width=48, height=48, spp=128, max_depth=5),
                         seed=11, device="cpu")
    return recon, aux, ref


def test_gdpt_reconstruction_matches_path_mean(gdpt_run):
    recon, aux, ref = gdpt_run
    assert np.isfinite(recon).all()
    assert abs(recon.mean() - ref.mean()) / ref.mean() < 0.1


def test_gdpt_reconstruction_beats_matched_primal(gdpt_run):
    """Reconstructing from the noise-matched BF primal clearly beats that
    primal."""
    recon, aux, ref = gdpt_run
    recon_bf = poisson.screened_poisson_solve(
        torch.as_tensor(aux["primal_bf"]), torch.as_tensor(aux["gx"]),
        torch.as_tensor(aux["gy"]), 0.04).numpy()
    assert _rmse(recon_bf, ref) < 0.8 * _rmse(aux["primal_bf"], ref)


def test_gdpt_nee_primal_not_degraded(gdpt_run):
    recon, aux, ref = gdpt_run
    assert _rmse(recon, ref) < 1.15 * _rmse(aux["primal"], ref)


def test_gdpt_gradients_sane(gdpt_run):
    recon, aux, ref = gdpt_run
    gx_ref = np.zeros_like(ref)
    gx_ref[:, 1:] = ref[:, 1:] - ref[:, :-1]
    corr = np.corrcoef(aux["gx"][:, 1:].ravel(), gx_ref[:, 1:].ravel())[0, 1]
    assert corr > 0.5, corr


@pytest.mark.gpu
def test_cuda_golden_cbox_gdpt():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert golden_ratio("cuda") < 0.05
