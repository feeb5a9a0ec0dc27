"""Ray casting for the reference: Moeller-Trumbore triangles, every ray
against every triangle (the benchmark's scenes are small).

A cast returns, per ray, the closest hit within [tnear, tfar): its t,
the triangle (its index in the description's order, -1 for a miss) and
the triangle's unnormalised normal cross(e1, e2); an occlusion cast says
whether any triangle lies within [tnear, tfar).
"""

from typing import NamedTuple

import numpy as np
import torch

BRUTE_CHUNK = 1 << 17   # rays a batch


class Geometry(NamedTuple):
    v0: torch.Tensor   # (T, 3)
    e1: torch.Tensor
    e2: torch.Tensor

    @staticmethod
    def build(tris, device, dtype):
        """tris: (T, 3, 3) float64 vertices, in the description's order."""
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)

        return Geometry(dev(tris[:, 0]), dev(tris[:, 1] - tris[:, 0]),
                        dev(tris[:, 2] - tris[:, 0]))


def _mt(g, tri, o, d):
    """Moeller-Trumbore of rays (o, d), each (K,) per component, against
    triangles tri (K,): (t, hit-in-triangle)."""
    v0, e1, e2 = g.v0[tri], g.e1[tri], g.e2[tri]
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2[:, 2] - dz * e2[:, 1]
    py = dz * e2[:, 0] - dx * e2[:, 2]
    pz = dx * e2[:, 1] - dy * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    inv = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    tx, ty, tz = ox - v0[:, 0], oy - v0[:, 1], oz - v0[:, 2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv
    return t, (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)


def _brute(g, o, d, tnear, tfar):
    n = o[0].shape[0]
    n_t = g.v0.shape[0]
    best = tfar.clone()
    prim = torch.full((n,), -1, dtype=torch.int64, device=best.device)
    for lo in range(0, n, BRUTE_CHUNK):
        sl = slice(lo, min(n, lo + BRUTE_CHUNK))
        k = sl.stop - sl.start
        tri = torch.arange(n_t, device=best.device).repeat_interleave(k)
        oo = tuple(c[sl].repeat(n_t) for c in o)
        dd = tuple(c[sl].repeat(n_t) for c in d)
        t, inside = _mt(g, tri, oo, dd)
        tn = tnear[sl].repeat(n_t)
        ok = inside & (t >= tn) & (t < tfar[sl].repeat(n_t))
        t = torch.where(ok, t, torch.inf).reshape(n_t, k)
        i = torch.argmin(t, dim=0)
        ti = t.gather(0, i[None])[0]
        closer = ti < best[sl]
        best[sl] = torch.where(closer, ti, best[sl])
        prim[sl] = torch.where(closer, i, prim[sl])
    return best, prim


def closest(g, o, d, tnear, tfar):
    """(t, prim, normal): t is tfar, prim -1 and the normal (0, 0, 1) on a
    miss. o, d: vectors; tnear: a float or (N,); tfar: (N,)."""
    tnear = torch.broadcast_to(torch.as_tensor(tnear, dtype=tfar.dtype, device=tfar.device),
                               tfar.shape)
    t, i = _brute(g, o, d, tnear, tfar)
    hit = i >= 0
    ic = torch.clamp_min(i, 0)
    e1, e2 = g.e1[ic], g.e2[ic]
    one = torch.ones_like(t)
    n = (torch.where(hit, e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1], 0 * one),
         torch.where(hit, e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2], 0 * one),
         torch.where(hit, e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0], one))
    return t, torch.where(hit, i, -1), n


def occluded(g, o, d, tnear, tfar):
    """Whether a triangle lies within [tnear, tfar) of each ray (bool)."""
    tnear = torch.broadcast_to(torch.as_tensor(tnear, dtype=tfar.dtype, device=tfar.device),
                               tfar.shape)
    return _brute(g, o, d, tnear, tfar)[1] >= 0
