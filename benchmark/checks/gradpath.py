"""`correct` for `gradpath` frames: whole reconstructions against the
plain reference.

The sampled frames (drawn from the run's seed among the window's) are
rendered again by benchmark/reference/gradpath.py at their seeds and
samples per pixel, every pixel, and reconstructed by the reference's
float64 solve (benchmark/reference/poisson.py) at the config's
`gdpt_alpha`. The program's reconstruction is compared value by value
(pixels x rgb):

- off_share: the largest share, over the sampled frames, of a frame's
  values outside rtol * |reference| + atol;
- mean_gap: the largest relative gap between a frame's mean and the
  reference's. The solve puts the data term's mean back, so this reads
  the primal alone;
- grad_gap: the largest relative gap between a frame's mean absolute
  finite difference along x plus that along y and the reference's: the
  reading a fault in the gradients moves where the mean cannot.
"""

import numpy as np

from benchmark.reference import gradpath, poisson, scene


def reference_frames(desc, cfg, frames, spp, device, dtype=None):
    """The reference's reconstructions (h, w, 3) float64 of the (index,
    seed, output) frames, rendered in `dtype` (float32 by default) and
    solved in float64."""
    import torch

    gradpath.check_lambertian(desc)
    rs = scene.build(desc, device, dtype or torch.float32)
    out = []
    for _, s, _ in frames:
        b = gradpath.render_gradpath(rs, spp, s)
        out.append(poisson.solve(b["primal"], b["gx"], b["gy"], cfg["gdpt_alpha"], device))
    return out


def roughness(img):
    """Mean |finite difference| along x plus that along y."""
    return (float(np.mean(np.abs(np.diff(img, axis=1))))
            + float(np.mean(np.abs(np.diff(img, axis=0)))))


def compare(run):
    lim = run["cfg"]["check"]
    refs = reference_frames(run["desc"], run["cfg"], run["frames"], run["spp"], run["device"])
    off, gap, ggap = [], 0.0, 0.0
    for (_, _, img), ref in zip(run["frames"], refs):
        img = np.nan_to_num(np.asarray(img, np.float64), nan=np.inf)
        d = np.abs(img - ref)
        off.append(float(np.mean(~(d <= lim["rtol"] * np.abs(ref) + lim["atol"]))))
        gap = max(gap, float(abs(img.mean() - ref.mean()) / max(abs(ref.mean()), 1e-30)))
        r = roughness(ref)
        ggap = max(ggap, abs(roughness(img) - r) / max(r, 1e-30))
    if not off:
        gap = ggap = 1.0
    return {"off_share": {"value": max(off) if off else 1.0,
                          "limit": lim["limits"]["off_share"]},
            "mean_gap": {"value": gap, "limit": lim["limits"]["mean_gap"]},
            "grad_gap": {"value": ggap, "limit": lim["limits"]["grad_gap"]}}
