"""frame_ms_p95: the 95th percentile of all frames' times in the window,
each from the call to the image in host memory, in ms (linear
interpolation between order statistics). Nothing where the window holds
fewer than 200 frames: the tail needs ten frames beyond it."""

import numpy as np


def read(rec):
    if len(rec.frames) < 200:
        return None
    return float(np.percentile([f.seconds * 1e3 for f in rec.frames], 95))
