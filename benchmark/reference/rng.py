"""The frames' random numbers: counter-based PCG3D streams.

Every random number of a frame is a pure function of (frame seed, pixel,
use site, sample): PCG3D (Jarzynski and Olano, JCGT 9(3), 2020) over the
words (premixed pixel, use-site counter, seed + sample * golden ratio),
the pixel premixed by the murmur3 finalizer, and the two first outputs
scaled into [0, 1) by 1 / 4294967808 in float32. The renderer draws at
counter 16 * bounce + site, with the sites below. uint32 arithmetic is
carried in int64 tensors.
"""

import torch

M32 = 0xFFFFFFFF
SITE_PIXEL, SITE_LIGHT_UV, SITE_LIGHT_W, SITE_BSDF_UV, SITE_BSDF_W = 0, 1, 2, 3, 4
SITE_STRIDE = 16
_SCALE = float(torch.tensor(1.0 / 4294967808.0, dtype=torch.float32))


def _lcg(v):
    return (v * 1664525 + 1013904223) & M32


def uniform2(seed, pixel, counter, sample, dtype=torch.float32):
    """Two uniforms in [0, 1) per lane. seed: an int; pixel: (N,) int64;
    counter: an int; sample: an int or (N,) int64."""
    p = pixel.to(torch.int64) & M32
    smp = torch.as_tensor(sample, dtype=torch.int64, device=p.device) & M32
    t = (p * 0x9E3779B9) & M32
    t = t ^ (t >> 16)
    t = (t * 0x85EBCA6B) & M32
    t = t ^ (t >> 13)
    x = _lcg(t)
    y = _lcg(torch.full_like(p, int(counter) & M32))
    z = _lcg(((int(seed) & M32) + smp * 0x9E3779B9) & M32).expand_as(p)
    x = (x + y * z) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + y * z) & M32
    y = (y + z * x) & M32
    return ((x.to(torch.float32) * _SCALE).to(dtype), (y.to(torch.float32) * _SCALE).to(dtype))
