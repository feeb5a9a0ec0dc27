"""Vector math over (..., 3) tensors, for the per-ray integrators.

Counterpart of gdpt_tpu/core/math.py: the reference's per-ray functions
with its vmap axis made the leading dimension, so a vector is an (N, 3)
tensor, a scalar per lane an (N,) tensor and a frame an (N, 3, 3) tensor
of rows tangent, bitangent, normal. Sums over the three components are
written out in the reference's order (x + y) + z.
"""

import math

import torch

from gdpt_tpu_torch.core.dtypes import REAL


def lift(s):
    """(N,) per-lane scalar -> (N, 1), to scale or select (N, 3) vectors."""
    return s[..., None]


def where(c, a, b):
    """jnp.where with a per-lane condition against vectors or frames: c is
    (N,), a and b are tensors of (N, ...) or Python scalars."""
    dims = max(x.dim() if isinstance(x, torch.Tensor) else 0 for x in (a, b))
    c = c.reshape(c.shape + (1,) * (dims - c.dim())) if dims > c.dim() else c
    return torch.where(c, a, b)


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_squared(v))


def normalize(v, eps=0.0):
    l = length(v)
    if eps:
        l = torch.clamp_min(l, eps)
    return v / l[..., None]


def distance(a, b):
    return length(a - b)


def distance_squared(a, b):
    return length_squared(a - b)


def apply3(m, v):
    """A matrix m (R, 3) (a 4x4's upper rows, say) applied to every row
    of v (N, 3): (N, R), each entry summed in the order x, y, z."""
    return v[:, None, 0] * m[:, 0] + v[:, None, 1] * m[:, 1] + v[:, None, 2] * m[:, 2]


def coordinate_system(n):
    """Frisvad's branchless construction with the n.z ~ -1 guard
    (reference: src/frame.h:12-22)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    degenerate = nz < (-1.0 + 1e-6)
    a = 1.0 / torch.where(degenerate, 1.0, 1.0 + nz)
    b = -nx * ny * a
    t0 = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    t1 = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    t0_deg = torch.tensor([0.0, -1.0, 0.0], dtype=REAL, device=n.device).expand(t0.shape)
    t1_deg = torch.tensor([-1.0, 0.0, 0.0], dtype=REAL, device=n.device).expand(t1.shape)
    return where(degenerate, t0_deg, t0), where(degenerate, t1_deg, t1)


def make_frame(n):
    """Orthonormal frame (x, y, n) from unit normal n; shape (..., 3, 3)."""
    x, y = coordinate_system(n)
    return torch.stack([x, y, n], dim=-2)


def frame_from_tangent(t, b, n):
    return torch.stack([t, b, n], dim=-2)


def to_local(frame, v):
    """World vector -> frame coordinates (reference: src/frame.h:50)."""
    return torch.stack([dot(frame[..., 0, :], v), dot(frame[..., 1, :], v),
                        dot(frame[..., 2, :], v)], dim=-1)


def to_world(frame, v):
    """Frame-local vector back to world (reference: src/frame.h:55)."""
    return (frame[..., 0, :] * v[..., 0:1] + frame[..., 1, :] * v[..., 1:2]
            + frame[..., 2, :] * v[..., 2:3])


def sample_cos_hemisphere(uv):
    """Cosine-weighted hemisphere sample in local coordinates (z up)."""
    phi = 2.0 * math.pi * uv[..., 0]
    t = torch.sqrt(torch.clamp(1.0 - uv[..., 1], 0.0, 1.0))
    r = torch.sqrt(uv[..., 1])
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), t], dim=-1)


def sample_uniform_sphere(uv):
    z = 1.0 - 2.0 * uv[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * uv[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))
