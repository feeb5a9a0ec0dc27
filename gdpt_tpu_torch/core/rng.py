"""Counter-based RNG of the per-ray integrators, bit for bit jax.random's.

Counterpart of gdpt_tpu/core/rng.py. The reference's per-ray rungs read
every random number through ``jax.random`` on ``PRNGKey(seed)``: a key
per (pixel, sample) lane, folded per (bounce, use site). This module
reproduces jax's threefry layout (``jax_threefry_partitionable``, the
default, with 32-bit keys) on lane-batched tensors:

- ``PRNGKey(s)`` is the words ``(0, s)``;
- ``fold_in(k, d)`` is both output words of ``threefry2x32(k, (0, d))``;
- element ``i`` of ``uniform(k, shape)`` takes ``(w0, w1) =
  threefry2x32(k, (0, i))``, ``bits = w0 ^ w1``, and the value
  ``bitcast_f32((bits >> 9) | 0x3F800000) - 1``.

A key is a pair of int64 tensors of uint32 words, one entry per lane
(core/soa.py's threefry2x32 works in int64 with the low 32 bits kept).
Every draw costs a fold_in and a threefry: about 170 elementwise
launches each in eager torch.
"""

import torch

from gdpt_tpu_torch.core.dtypes import REAL
from gdpt_tpu_torch.core.soa import threefry2x32

# Use-site slots, folded together with the bounce index (the reference's
# numbering; see gdpt_tpu/core/rng.py for what each one draws).
SLOT_PIXEL = 0
SLOT_LIGHT_UV = 1
SLOT_LIGHT_W = 2
SLOT_SHAPE_W = 3
SLOT_BSDF_UV = 4
SLOT_BSDF_W = 5
SLOT_RR = 6
SLOT_DISTANCE = 7
SLOT_CHANNEL = 8
SLOT_PHASE_UV = 9
SLOT_NULL_LOOP = 10
SLOT_NEE_LOOP = 48

_SLOT_STRIDE = 256
_M32 = 0xFFFFFFFF


def _words(x, like):
    """Scalar or tensor -> int64 tensor of uint32 words shaped like `like`."""
    if isinstance(x, torch.Tensor):
        return (x.to(torch.int64) & _M32).expand(like.shape)
    return torch.full(like.shape, int(x) & _M32, dtype=torch.int64, device=like.device)


def prng_key(seed, n, device="cpu"):
    """jax.random.PRNGKey(seed) for n lanes: the words (0, seed)."""
    k1 = torch.full((n,), int(seed) & _M32, dtype=torch.int64, device=device)
    return torch.zeros_like(k1), k1


def fold_in(key, data):
    """jax.random.fold_in per lane; data is a Python int or an (N,) tensor."""
    k0, k1 = key
    return threefry2x32(k0, k1, torch.zeros_like(k0), _words(data, k0))


def _bits_to_unit(bits):
    """Mantissa trick of jax.random.uniform on [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).to(REAL)


def random_uniform(key, shape=()):
    """jax.random.uniform(key, shape) per lane: (N,) for shape (), else
    (N, *shape)."""
    k0, k1 = key
    size = 1
    for s in shape:
        size *= s
    if not shape:
        w0, w1 = threefry2x32(k0, k1, torch.zeros_like(k0), torch.zeros_like(k0))
        return _bits_to_unit(w0 ^ w1)
    n = k0.shape[0]
    idx = torch.arange(size, dtype=torch.int64, device=k0.device).expand(n, size)
    a0, a1 = k0[:, None].expand(n, size), k1[:, None].expand(n, size)
    w0, w1 = threefry2x32(a0, a1, torch.zeros_like(idx), idx)
    return _bits_to_unit(w0 ^ w1).reshape((n,) + tuple(shape))


def ray_key(base_key, ray_idx):
    """Key of one (pixel, sample) lane; ray_idx = pixel_idx * spp + sample."""
    return fold_in(base_key, ray_idx)


def site_key(key, bounce, slot):
    """bounce: a Python int or a per-lane (N,) tensor."""
    return fold_in(key, bounce * _SLOT_STRIDE + slot)


def uniform(key, bounce, slot, shape=()):
    """Uniforms in [0, 1) for one use site of one bounce."""
    return random_uniform(site_key(key, bounce, slot), shape)


def loop_uniform(key, bounce, slot, iteration, shape=()):
    """Uniforms for iteration `iteration` of an inner loop at a use site."""
    return random_uniform(fold_in(site_key(key, bounce, slot), iteration), shape)
