"""Brute-force ray casting kernels (K1 closest hit, K2 any hit).

Counterpart of gdpt_tpu/accel/pallas_intersect.py. The hand-written
Hopper kernels live in csrc/brute_intersect.cu; this module builds them
at first use (accel/native_build.py: nvcc, keyed by a hash of the source
and flags, into build/gdpt_tpu_torch/ of the checkout), binds them with
ctypes and launches them on PyTorch's current stream.

Each wrapper takes its plain PyTorch version only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises: there is no
fallback. LAUNCHES counts kernel launches, one per call that reached a
kernel, so a run can show that its main path went through them.

Both kernels take a per-ray tfar and a tnear, a scalar for every ray or
an (N,) tensor (the wavefront casts primary rays from 0 and bounce rays
from the intersection epsilon in one launch), and look for hits within
[tnear, tfar); a lane with tfar <= tnear is dead and gets a miss. The
plain versions repeat the kernels' arithmetic operation for operation
(broadcast over (primitives, rays); argmin takes the first minimum,
which is the kernel's lowest-index tie rule), so the two agree bit for
bit.
"""

import ctypes

import numpy as np
import torch

from gdpt_tpu_torch.accel import native_build
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL

MAX_PRIMS = 128  # per soup; the shared-memory staging size of the kernels

LAUNCHES = {"intersect": 0, "occluded": 0}

SOURCE = "brute_intersect.cu"

_lib = None


def build(verbose=False):
    """Compile csrc/brute_intersect.cu (see native_build.build)."""
    return native_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gdpt_intersect_brute.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, i, f,
                                             p, p, p, p, p, p, p, p]
        lib.gdpt_intersect_brute.restype = i
        lib.gdpt_occluded_brute.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, i, f,
                                            p, p]
        lib.gdpt_occluded_brute.restype = i
        _lib = lib
    return _lib


def _tnear(tnear):
    """tnear as an f32-rounded Python float, or as the (N,) tensor it is."""
    if isinstance(tnear, torch.Tensor) and tnear.dim():
        return tnear
    return float(np.float32(tnear))


def _check(tri_soup, sph_soup, n_tris, n_sph, rays, tnear):
    """(N, device, tnear (_tnear)); a per-ray tnear is checked as a ray
    component."""
    tnear = _tnear(tnear)
    if isinstance(tnear, torch.Tensor):
        rays = (*rays, tnear)
    n = rays[0].shape[0]
    dev = rays[0].device
    if not (0 <= n_tris <= MAX_PRIMS and 0 <= n_sph <= MAX_PRIMS):
        raise ValueError(f"brute kernels take at most {MAX_PRIMS} triangles and "
                         f"{MAX_PRIMS} spheres, got {n_tris} and {n_sph}")
    if tri_soup.shape != (9, max(n_tris, 1)) or sph_soup.shape != (4, max(n_sph, 1)):
        raise ValueError(f"soup shapes {tuple(tri_soup.shape)}, {tuple(sph_soup.shape)} "
                         f"do not fit {n_tris} triangles and {n_sph} spheres")
    for a in (tri_soup, sph_soup, *rays):
        if a.dtype != REAL or a.device != dev or not a.is_contiguous():
            raise ValueError("brute kernels take contiguous float32 tensors on one device")
    for a in rays:
        if a.shape != (n,):
            raise ValueError("ray components must all be (N,)")
    if n >= 2 ** 31:
        raise ValueError("brute kernels take fewer than 2^31 rays")
    return n, dev, tnear


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _tnear_args(tnear):
    """The kernels' (per-ray tnear pointer or null, scalar tnear)."""
    if isinstance(tnear, torch.Tensor):
        return _ptr(tnear), 0.0
    return ctypes.c_void_p(None), tnear


def _tri_test_rows(tri_soup, n_tris, o, d, tnear, tfar):
    """All triangles x all rays, (T, N): (t, u, v, hit), in the kernels'
    Moeller-Trumbore operation order."""
    s = tri_soup[:, :n_tris, None]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = s
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= tnear) & (t < tfar)
    return t, u, v, hit


def _sphere_roots_rows(sph_soup, n_sph, o, d):
    """All spheres x all rays, (S, N): roots t0 <= t1 and disc >= 0 & a != 0."""
    cx, cy, cz, r = sph_soup[:, :n_sph, None]
    ox, oy, oz = o
    dx, dy, dz = d
    vx = ox - cx
    vy = oy - cy
    vz = oz - cz
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / torch.where(a != 0, a, 1.0)
    tm = -(dx * vx + dy * vy + dz * vz) * inv_a
    mx = vx + dx * tm
    my = vy + dy * tm
    mz = vz + dz * tm
    disc = r * r - (mx * mx + my * my + mz * mz)
    dt = torch.sqrt(torch.clamp_min(disc, 0.0) * inv_a)
    return tm - dt, tm + dt, (disc >= 0) & (a != 0)


def _sphere_test_rows(sph_soup, n_sph, o, d, tnear, tfar):
    """(t, hit) of every sphere within [tnear, tfar) (per ray tfar)."""
    t0, t1, ok = _sphere_roots_rows(sph_soup, n_sph, o, d)
    use_lo = (t0 >= tnear) & (t0 < tfar)
    use_hi = (t1 >= tnear) & (t1 < tfar)
    return torch.where(use_lo, t0, t1), ok & (use_lo | use_hi)


def intersect_brute_plain(tri_soup, sph_soup, n_tris, n_sph,
                          ox, oy, oz, dx, dy, dz, tfar, tnear):
    """K1's contract in plain PyTorch: (t, prim, u, v, gx, gy, gz)."""
    tnear = _tnear(tnear)
    n = ox.shape[0]
    dev = ox.device
    o, d = (ox, oy, oz), (dx, dy, dz)
    lane = torch.arange(n, device=dev)
    best_t = tfar
    prim = torch.full((n,), -1, dtype=INT, device=dev)
    u = torch.zeros(n, dtype=REAL, device=dev)
    v = torch.zeros(n, dtype=REAL, device=dev)
    gx, gy = torch.zeros_like(u), torch.zeros_like(u)
    gz = torch.ones_like(u)
    if n_tris:
        t, tu, tv, hit = _tri_test_rows(tri_soup, n_tris, o, d, tnear, tfar)
        t = torch.where(hit, t, torch.inf)
        i = torch.argmin(t, dim=0)
        ti = t[i, lane]
        closer = ti < best_t
        e1x, e1y, e1z, e2x, e2y, e2z = (tri_soup[c, :n_tris][i] for c in range(3, 9))
        best_t = torch.where(closer, ti, best_t)
        prim = torch.where(closer, i.to(INT), prim)
        u = torch.where(closer, tu[i, lane], u)
        v = torch.where(closer, tv[i, lane], v)
        gx = torch.where(closer, e1y * e2z - e1z * e2y, gx)
        gy = torch.where(closer, e1z * e2x - e1x * e2z, gy)
        gz = torch.where(closer, e1x * e2y - e1y * e2x, gz)
    if n_sph:
        t, hit = _sphere_test_rows(sph_soup, n_sph, o, d, tnear, best_t)
        t = torch.where(hit, t, torch.inf)
        i = torch.argmin(t, dim=0)
        ti = t[i, lane]
        closer = ti < best_t
        cx, cy, cz = (sph_soup[c, :n_sph][i] for c in range(3))
        best_t = torch.where(closer, ti, best_t)
        prim = torch.where(closer, (n_tris + i).to(INT), prim)
        gx = torch.where(closer, ox + ti * dx - cx, gx)
        gy = torch.where(closer, oy + ti * dy - cy, gy)
        gz = torch.where(closer, oz + ti * dz - cz, gz)
    return torch.where(prim >= 0, best_t, BIG), prim, u, v, gx, gy, gz


def occluded_brute_plain(tri_soup, sph_soup, n_tris, n_sph,
                         ox, oy, oz, dx, dy, dz, tfar, tnear):
    """K2's contract in plain PyTorch: blocked (N,) float32 0/1."""
    tnear = _tnear(tnear)
    o, d = (ox, oy, oz), (dx, dy, dz)
    blocked = torch.zeros(ox.shape[0], dtype=torch.bool, device=ox.device)
    if n_tris:
        blocked |= _tri_test_rows(tri_soup, n_tris, o, d, tnear, tfar)[3].any(dim=0)
    if n_sph:
        blocked |= _sphere_test_rows(sph_soup, n_sph, o, d, tnear, tfar)[1].any(dim=0)
    return blocked.to(REAL)


def intersect_brute(tri_soup, sph_soup, n_tris, n_sph, ox, oy, oz, dx, dy, dz, tfar, tnear):
    """Closest hit of every ray within [tnear, tfar) over all primitives
    (K1); tnear a scalar or an (N,) tensor. Returns (t, prim, u, v, gx,
    gy, gz); a miss, and every lane with tfar <= tnear, gives t = BIG,
    prim = -1, u = v = 0, g = (0, 0, 1)."""
    rays = (ox, oy, oz, dx, dy, dz, tfar)
    n, dev, tnear = _check(tri_soup, sph_soup, n_tris, n_sph, rays, tnear)
    if dev.type == "cpu":
        return intersect_brute_plain(tri_soup, sph_soup, n_tris, n_sph, *rays, tnear)
    if dev.type != "cuda":
        raise ValueError(f"brute kernels run on cuda or cpu tensors, not {dev}")
    lib = _load()
    f = lambda: torch.empty(n, dtype=REAL, device=dev)  # noqa: E731
    t, u, v, gx, gy, gz = f(), f(), f(), f(), f(), f()
    prim = torch.empty(n, dtype=INT, device=dev)
    lane_tnear, tnear = _tnear_args(tnear)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gdpt_intersect_brute(
            _ptr(tri_soup), n_tris, _ptr(sph_soup), n_sph, *map(_ptr, rays), lane_tnear, n,
            tnear, _ptr(t), _ptr(prim), _ptr(u), _ptr(v),
            _ptr(gx), _ptr(gy), _ptr(gz), ctypes.c_void_p(stream))
    LAUNCHES["intersect"] += n > 0
    _raise_on(err, "intersect_brute_kernel")
    return t, prim, u, v, gx, gy, gz


def occluded_brute(tri_soup, sph_soup, n_tris, n_sph, ox, oy, oz, dx, dy, dz, tfar, tnear):
    """Any hit within [tnear, tfar) per ray (K2; tnear a scalar or an (N,)
    tensor); a lane with tfar <= tnear is dead and gives 0. Returns
    blocked (N,) float32 0/1."""
    rays = (ox, oy, oz, dx, dy, dz, tfar)
    n, dev, tnear = _check(tri_soup, sph_soup, n_tris, n_sph, rays, tnear)
    if dev.type == "cpu":
        return occluded_brute_plain(tri_soup, sph_soup, n_tris, n_sph, *rays, tnear)
    if dev.type != "cuda":
        raise ValueError(f"brute kernels run on cuda or cpu tensors, not {dev}")
    lib = _load()
    blocked = torch.empty(n, dtype=REAL, device=dev)
    lane_tnear, tnear = _tnear_args(tnear)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gdpt_occluded_brute(
            _ptr(tri_soup), n_tris, _ptr(sph_soup), n_sph, *map(_ptr, rays), lane_tnear, n,
            tnear, _ptr(blocked), ctypes.c_void_p(stream))
    LAUNCHES["occluded"] += n > 0
    _raise_on(err, "occluded_brute_kernel")
    return blocked


def pack_soups(tri_v0, tri_e1, tri_e2, sph_center, sph_radius, n_tris, n_sph):
    """The (9, T) and (4, S) primitive soups of the kernels (a zero
    column when a soup is empty), from V3 component tensors."""
    dev = tri_v0.x.device
    if n_tris:
        tri = torch.stack([tri_v0.x, tri_v0.y, tri_v0.z, tri_e1.x, tri_e1.y,
                           tri_e1.z, tri_e2.x, tri_e2.y, tri_e2.z]).contiguous()
    else:
        tri = torch.zeros((9, 1), dtype=REAL, device=dev)
    if n_sph:
        sph = torch.stack([sph_center.x, sph_center.y, sph_center.z,
                           sph_radius]).contiguous()
    else:
        sph = torch.zeros((4, 1), dtype=REAL, device=dev)
    return tri, sph
