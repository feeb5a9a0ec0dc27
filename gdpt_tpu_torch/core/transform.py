"""Host-side 4x4 transforms (numpy, float64).

Scene construction happens on host in double precision; matrices are cast
to the device dtype only when frozen into the device scene.
Replaces reference: src/transform.h/.cpp and src/matrix.h.
"""

import numpy as np


def identity():
    return np.eye(4, dtype=np.float64)


def translate(delta):
    m = identity()
    m[:3, 3] = delta
    return m


def scale(s):
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate(angle_deg, axis):
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.radians(angle_deg))
    c = np.cos(np.radians(angle_deg))
    m = identity()
    m[:3, :3] = (
        c * np.eye(3)
        + (1 - c) * np.outer(a, a)
        + s * np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    )
    return m


def look_at(pos, target, up):
    pos = np.asarray(pos, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = target - pos
    d = d / np.linalg.norm(d)
    up_n = up / np.linalg.norm(up)
    left = np.cross(up_n, d)
    norm = np.linalg.norm(left)
    if norm == 0:
        raise ValueError("look_at: up parallel to viewing direction")
    left = left / norm
    new_up = np.cross(d, left)
    m = identity()
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = pos
    return m


def perspective(fov_deg):
    """Perspective projection matrix as in reference: src/transform.cpp:76-82."""
    cot = 1.0 / np.tan(np.radians(fov_deg / 2.0))
    return np.array(
        [
            [cot, 0, 0, 0],
            [0, cot, 0, 0],
            [0, 0, 1, -1],
            [0, 0, 1, 0],
        ],
        dtype=np.float64,
    )


def inverse(m):
    return np.linalg.inv(m)


def xform_point(m, p):
    q = m[:3, :3] @ p + m[:3, 3]
    w = m[3, :3] @ p + m[3, 3]
    return q / w


def xform_vector(m, v):
    return m[:3, :3] @ v


def xform_normal(inv_m, n):
    r = inv_m[:3, :3].T @ n
    return r / np.linalg.norm(r)
