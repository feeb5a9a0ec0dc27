"""Three-component vectors as tuples of (N,) tensors, with the arithmetic
of a path tracer written out component by component."""

import torch


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    """Component-wise product of two vectors."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    return scale(a, 1.0 / torch.clamp_min(length(a), 1e-20))


def vmax(a):
    return torch.maximum(torch.maximum(a[0], a[1]), a[2])


def where(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def take(rows, idx):
    """Rows (K, 3) gathered at idx as a vector."""
    g = rows[idx]
    return (g[:, 0], g[:, 1], g[:, 2])


def zeros(n, like):
    z = torch.zeros(n, dtype=like.dtype, device=like.device)
    return (z, z, z)


def basis(n):
    """An orthonormal frame (t, b, n) around the unit vector n (Frisvad's
    construction, with the pole n.z = -1 handled apart)."""
    degen = n[2] < (-1.0 + 1e-6)
    a = 1.0 / (1.0 + torch.where(degen, 0.0, n[2]))
    b = -n[0] * n[1] * a
    t = (1.0 - n[0] * n[0] * a, b, -n[0])
    bt = (b, 1.0 - n[1] * n[1] * a, -n[1])
    z = torch.zeros_like(n[0])
    t = where(degen, (z, z - 1.0, z), t)
    bt = where(degen, (z - 1.0, z, z), bt)
    return t, bt, n


def to_world(frame, v):
    t, b, n = frame
    return (t[0] * v[0] + b[0] * v[1] + n[0] * v[2],
            t[1] * v[0] + b[1] * v[1] + n[1] * v[2],
            t[2] * v[0] + b[2] * v[1] + n[2] * v[2])
