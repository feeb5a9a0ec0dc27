"""Render checkpoint / resume, counterpart of gdpt_tpu/utils/checkpoint.py.

The reference has none (SURVEY.md section 5: renders are one-shot).
Monte Carlo accumulation makes checkpointing natural: persist the
running per-pixel sums and the sample count; resuming continues the
deterministic counter-based sample streams exactly where they stopped.

Covers the accumulating integrators the port renders, dispatched as
render.render dispatches them: path (the SoA render, or the per-ray
path.trace_path through render_samples), volpath (versions 6 and 0 on
the SoA banded loop, versions 1-5 on the per-ray rungs' render_samples)
and gradpath (the SoA render, or the per-ray gdpt.render_gradpath),
whose 6-buffer accumulator state — primal, brute-force primal, 4
one-sided gradients — is saved before the Poisson reconstruction. The
SoA accumulators are (3, n_pix) and (6, 3, n_pix), the per-ray ones
(n_pix, 3) and (6, n_pix, 3), as the reference's. The SoA integrators
resume on their banded loops.
Checkpoints carry a scene/seed/spp fingerprint; a stale file from a
different render is discarded rather than corrupting the accumulator.
The file holds numpy arrays only, so a checkpoint written by a render on
one device resumes a render of the same scene on another.
"""

import functools
import hashlib
import warnings
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

from gdpt_tpu_torch.convert import tree_leaves
from gdpt_tpu_torch.core.dtypes import resolve_device
from gdpt_tpu_torch.integrators import gdpt, gdpt_soa, path_soa, render, volpath, volpath_soa
from gdpt_tpu_torch.integrators import path as path_integrator
from gdpt_tpu_torch.scene.build import scene_to


def _fingerprint(scene, spp, seed):
    """Deterministic digest of everything the accumulator depends on.

    SceneStatic is a frozen dataclass of plain ints/floats/tuples, so its
    repr is stable across processes (unlike Python hash()). Static facts
    alone are not enough: two renders of the same scene file with an
    edited light or material value share every count/flag, so the digest
    also folds in the scene *content* — every tensor leaf's shape/dtype
    plus a CRC32 of its full bytes, read on the host, so the digest does
    not depend on the device the scene lives on.
    """
    h = hashlib.sha1(f"{scene.static!r}|spp={spp}|seed={seed}|v4".encode())
    for leaf in tree_leaves(scene.device):
        a = leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        a = np.ascontiguousarray(a)
        crc = zlib.crc32(a.view(np.uint8).reshape(-1))
        h.update(f"|{a.shape}{a.dtype}{crc}".encode())
    return h.hexdigest()


def save_checkpoint(path, acc, samples_done, fingerprint=""):
    """Atomic save (write-temp + rename) of the raw accumulator sums."""
    tmp = Path(str(path) + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, acc=acc, samples_done=samples_done,
                 fingerprint=fingerprint)
    tmp.replace(path)


def load_checkpoint(path, fingerprint="", expected_shape=None):
    """Returns (acc, samples_done); (None, 0) if absent or mismatched."""
    if not Path(path).exists():
        return None, 0
    try:
        with np.load(path, allow_pickle=False) as data:
            acc = data["acc"]
            done = int(data["samples_done"])
            ckpt_fp = str(data["fingerprint"]) if "fingerprint" in data else ""
    except (OSError, ValueError, KeyError, EOFError, zlib.error, zipfile.BadZipFile) as e:
        # truncated/corrupt file: start over
        warnings.warn(f"discarding unreadable checkpoint {path}: {e}")
        return None, 0
    if fingerprint and ckpt_fp != fingerprint:
        warnings.warn(
            f"discarding checkpoint {path}: scene/spp/seed fingerprint "
            f"mismatch (stale checkpoint from a different render?)"
        )
        return None, 0
    if expected_shape is not None and tuple(acc.shape) != tuple(expected_shape):
        warnings.warn(
            f"discarding checkpoint {path}: accumulator shape "
            f"{acc.shape} != expected {expected_shape}"
        )
        return None, 0
    return acc, done


def render_with_checkpoints(scene, spp=None, seed=0, every=16,
                            path="render.ckpt.npz", device=None):
    """Checkpointed render on `device` (CUDA unless "cpu" is given).

    Dispatches on the scene's integrator like integrators.render.render
    (reference: src/render.cpp:374-394), resumes from `path` when it holds
    a checkpoint of this render, and checkpoints the raw accumulator
    roughly every `every` samples and at the end. Resuming is
    bit-deterministic: sample streams are counter-based on the absolute
    sample index. A checkpoint that cannot be written raises.
    """
    device = resolve_device(device)
    static = scene.static
    integrator = static.options.integrator
    spp = spp if spp is not None else static.options.samples_per_pixel
    n_pix = static.width * static.height
    if integrator == "path" and path_soa.supports_soa(scene):
        renderer, shape = path_soa.render_soa, (3, n_pix)
    elif integrator == "path":
        renderer = functools.partial(render.render_samples, trace_fn=path_integrator.trace_path)
        shape = (n_pix, 3)
    elif integrator == "volpath" and volpath_soa.supports_soa_volpath(scene):
        renderer, shape = volpath_soa.render_volpath_soa, (3, n_pix)
    elif integrator == "volpath":
        renderer = functools.partial(render.render_samples, trace_fn=volpath.trace_fn(static))
        shape = (n_pix, 3)
    elif integrator == "gradpath" and gdpt_soa.supports_soa_gdpt(scene):
        renderer, shape = gdpt_soa.render_gradpath_soa, (6, 3, n_pix)
    elif integrator == "gradpath":
        renderer = functools.partial(gdpt.render_gradpath, device=device)
        shape = (6, n_pix, 3)
    else:
        raise ValueError(
            f"integrator {integrator!r} is single-pass; checkpointing is for "
            "sample-accumulating integrators (path/volpath/gradpath)"
        )
    fp = _fingerprint(scene, spp, seed)
    acc, done = load_checkpoint(path, fp, shape)
    last_saved = [done]

    def on_chunk(acc, done):
        if done - last_saved[0] >= every or done >= spp:
            save_checkpoint(path, acc, done, fp)
            last_saved[0] = done

    return renderer(scene_to(scene, device), spp=spp, seed=seed, start_sample=done,
                    init_acc=acc, on_chunk=on_chunk)
