"""`correct` for `path` frames: whole frames against the plain reference.

The sampled frames (drawn from the run's seed among the window's) are
rendered again by benchmark/reference at their seeds and samples per
pixel, every pixel, and compared value by value (pixels x rgb):

- off_share: the largest share, over the sampled frames, of a frame's
  values outside rtol * |reference| + atol;
- mean_gap: the largest relative gap between a frame's mean and the
  reference's.

The reference draws the frame's own random numbers, so a sound frame
agrees but for the rare path that a rounding difference sends another
way.
"""

import numpy as np
import torch

from benchmark.reference import integrators, scene


def reference_frames(desc, frames, spp, device, dtype=torch.float32):
    """The reference's images (h, w, 3) of the (index, seed) frames."""
    rs = scene.build(desc, device, dtype)
    pixels = torch.arange(rs.width * rs.height, device=device)
    return [integrators.render_pixels(rs, pixels, spp, s).reshape(rs.height, rs.width, 3)
            for _, s, _ in frames]


def compare(run):
    lim = run["cfg"]["check"]
    refs = reference_frames(run["desc"], run["frames"], run["spp"], run["device"])
    off, gap = [], 0.0
    for (_, _, img), ref in zip(run["frames"], refs):
        img = np.nan_to_num(np.asarray(img, np.float64), nan=np.inf)
        d = np.abs(img - ref)
        off.append(float(np.mean(~(d <= lim["rtol"] * np.abs(ref) + lim["atol"]))))
        gap = max(gap, float(abs(img.mean() - ref.mean()) / max(abs(ref.mean()), 1e-30)))
    return {"off_share": {"value": max(off) if off else 1.0,
                          "limit": lim["limits"]["off_share"]},
            "mean_gap": {"value": gap if off else 1.0, "limit": lim["limits"]["mean_gap"]}}
