"""SoA (structure-of-arrays) compute primitives on tensors.

Counterpart of gdpt_tpu/core/soa.py: every vec3 is three (N,) component
tensors (V3), with the math the integrators need, and the counter-based
uniforms (pcg3d with a murmur premix, or threefry2x32 under
GDPT_RNG=threefry) reproduced bit for bit.

The RNG works in int64 with the low 32 bits kept after every add, mul
and shift: torch has no uint32 arithmetic on every backend, and int64
multiplication wraps, so the low 32 bits stay exact.

Expressions keep the reference's association order (Python folds scalar
constants in double in both frameworks, then one f32 op applies them).
"""

import os
from typing import NamedTuple

import torch

from gdpt_tpu_torch.core.dtypes import REAL


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def from_rows(arr):
    """(M, 3) tensor -> V3 of contiguous (M,) columns."""
    return V3(arr[:, 0].contiguous(), arr[:, 1].contiguous(),
              arr[:, 2].contiguous())


def stack(v: V3):
    """V3 -> one (3, N) tensor of rows x, y, z."""
    return torch.stack([v.x, v.y, v.z])


def unstack(rows) -> V3:
    """(3, N) tensor -> V3 of its rows (views)."""
    return V3(*rows.unbind(0))


def take(arr, idx):
    """Gather along axis 0 with clipped indices (jnp.take mode='clip')."""
    return arr[idx.clamp(0, arr.shape[0] - 1).long()]


def gather(v: V3, idx):
    idx = idx.clamp(0, v.x.shape[0] - 1).long()
    return V3(v.x[idx], v.y[idx], v.z[idx])


def where(c, a: V3, b: V3):
    return V3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y),
              torch.where(c, a.z, b.z))


def tree_map(fn, *trees):
    """Map fn over the tensor leaves of matching dict/NamedTuple/tuple
    trees (None and Python scalars pass through from the first tree)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else tuple(out)
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    return t0


def tree_where(c, a, b):
    return tree_map(lambda x, y: torch.where(c, x, y), a, b)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3):
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_squared(v: V3):
    return dot(v, v)


def length(v: V3):
    return torch.sqrt(length_squared(v))


def normalize(v: V3, eps=1e-20):
    inv = 1.0 / torch.clamp_min(length(v), eps)
    return v * inv


def vmax(v: V3):
    return torch.maximum(torch.maximum(v.x, v.y), v.z)


def luminance(v: V3):
    return v.x * 0.212671 + v.y * 0.715160 + v.z * 0.072169


class Frame(NamedTuple):
    t: V3
    b: V3
    n: V3


def coordinate_system(n: V3) -> Frame:
    """Frisvad's basis (reference: src/frame.h:12-22), branch-free."""
    degen = n.z < (-1.0 + 1e-6)
    safe_z = torch.where(degen, 0.0, n.z)
    a = 1.0 / (1.0 + safe_z)
    b = -n.x * n.y * a
    t = V3(1.0 - n.x * n.x * a, b, -n.x)
    bt = V3(b, 1.0 - n.y * n.y * a, -n.y)
    zeros = torch.zeros_like(n.x)
    t_d = V3(zeros, zeros - 1.0, zeros)
    bt_d = V3(zeros - 1.0, zeros, zeros)
    return Frame(where(degen, t_d, t), where(degen, bt_d, bt), n)


def to_local(f: Frame, v: V3) -> V3:
    return V3(dot(v, f.t), dot(v, f.b), dot(v, f.n))


def to_world(f: Frame, v: V3) -> V3:
    return V3(
        f.t.x * v.x + f.b.x * v.y + f.n.x * v.z,
        f.t.y * v.x + f.b.y * v.y + f.n.y * v.z,
        f.t.z * v.x + f.b.z * v.y + f.n.z * v.z,
    )


def flip(f: Frame, cond) -> Frame:
    s = torch.where(cond, -1.0, 1.0)
    return Frame(f.t * s, f.b * s, f.n * s)


# ---------------------------------------------------------------------------
# Counter-based RNG, uint32 semantics carried in int64
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def _u32(x, like):
    """Scalar or tensor -> int64 tensor of uint32 values, shaped like `like`."""
    if isinstance(x, torch.Tensor):
        return (x.to(torch.int64) & _M32).expand(like.shape).contiguous()
    return torch.full(like.shape, int(x) & _M32, dtype=torch.int64,
                      device=like.device)


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """threefry2x32, 20 rounds (Salmon et al., SC'11), on int64 tensors
    holding uint32 values. Returns two such tensors."""
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    keys = (k0, k1, ks2)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for block in range(5):
        for i in range(4):
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, _ROT[(block % 2) * 4 + i])
            x1 = x1 ^ x0
        x0 = (x0 + keys[(block + 1) % 3]) & _M32
        x1 = (x1 + keys[(block + 2) % 3] + (block + 1)) & _M32
    return x0, x1


def _lcg(v):
    return (v * 1664525 + 1013904223) & _M32


def pcg3d(v0, v1, v2):
    """PCG3D hash (Jarzynski & Olano, JCGT 2020) on int64 tensors holding
    uint32 values. Returns two mixed outputs."""
    return _pcg3d_rounds(_lcg(v0), _lcg(v1), _lcg(v2))


def _pcg3d_rounds(x, y, z):
    """pcg3d after its first LCG step of each word."""
    x = (x + y * z) & _M32
    y = (y + z * x) & _M32
    z = (z + x * y) & _M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + y * z) & _M32
    y = (y + z * x) & _M32
    return x, y


_RNG_IMPL = "pcg3d"  # set GDPT_RNG=threefry for the heavyweight streams


def threefry() -> bool:
    """Whether uniform2 draws from the threefry streams (GDPT_RNG=threefry)
    rather than PCG3D's; read at every call."""
    return os.environ.get("GDPT_RNG", _RNG_IMPL) == "threefry"

# f32 scale that keeps values < 1 (the reference's 1/4294967808 in f32).
_SCALE = float(torch.tensor(1.0 / 4294967808.0, dtype=REAL))


class Streams:
    """uniform2 at fixed (seed, stream, sample) for any counter: the
    words of the hash that do not depend on the counter are computed
    once, so a loop that draws at many counters pays the counter's part
    only. Bit-identical to uniform2."""

    def __init__(self, seed, stream, sample=0):
        s = stream.to(torch.int64) & _M32
        sd = _u32(seed, s)
        smp = _u32(sample, s)
        self.like = s
        self.threefry = threefry()
        if self.threefry:
            self.words = (sd, s, smp)
        else:
            # murmur3-finalizer premix of the stream id (see the reference).
            t = (s * 0x9E3779B9) & _M32
            t = t ^ (t >> 16)
            t = (t * 0x85EBCA6B) & _M32
            t = t ^ (t >> 13)
            self.words = (_lcg(t), _lcg((sd + smp * 0x9E3779B9) & _M32))

    def __call__(self, counter):
        """Two uniforms in [0, 1) per lane at `counter` (scalar or (N,))."""
        c = _u32(counter, self.like)
        if self.threefry:
            sd, s, smp = self.words
            r0, r1 = threefry2x32(sd, s, c, smp)
        else:
            x, z = self.words
            r0, r1 = _pcg3d_rounds(x, _lcg(c), z)
        return r0.to(REAL) * _SCALE, r1.to(REAL) * _SCALE


def uniform2(seed, stream, counter, sample=0):
    """Two uniforms in [0, 1) per lane, bit-identical to
    gdpt_tpu.core.soa.uniform2.

    seed: scalar uint32; stream: (N,) integer lane stream ids; counter:
    scalar or (N,) use-site counter; sample: scalar or (N,) sample index.
    """
    return Streams(seed, stream, sample)(counter)


def uniform1(seed, stream, counter, sample=0):
    return uniform2(seed, stream, counter, sample)[0]
