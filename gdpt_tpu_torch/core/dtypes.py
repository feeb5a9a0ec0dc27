"""Global dtype policy and device selection.

float32 compute, as in gdpt_tpu/core/dtypes.py. Entry points run on the
CUDA card unless the caller asks for the CPU; without a card and without
an explicit device they raise instead of carrying on quietly on the CPU.
"""

import numpy as np
import torch

REAL = torch.float32
INT = torch.int32

# Large-but-finite stand-in for +inf ray extents (inf - inf = nan hazards).
BIG = 1e30


def asarray(x, dtype=None, device="cpu") -> torch.Tensor:
    """Host value -> tensor with jnp.asarray's 32-bit defaults (float64
    narrows to float32, int64 to int32), so tables built here match the
    reference's leaf for leaf."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    a = np.asarray(x)
    if dtype is None:
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def resolve_device(device=None) -> torch.device:
    """`device` as given, else the CUDA card; raises if CUDA is requested
    (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gdpt_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
