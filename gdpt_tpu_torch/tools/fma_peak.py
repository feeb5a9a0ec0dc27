"""The card's measured float32 FMA rate, the speed-of-light's arithmetic peak.

Counterpart of measure_vpu_peak in tools/speed_of_light.py: four
independent y = y * a + b chains per value over a block of 2^22 values,
64 x 64 fused multiply-adds a chain, timed; 2 x 4 x n x steps flops over
the time is the peak. The reference's loop is one XLA fusion on a block in
VMEM; here it is a hand-written kernel (csrc/fma_peak.cu) whose threads
keep the chains in registers, since eager elementwise steps would measure
device memory. `fma_peak` takes its plain PyTorch version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
LAUNCHES counts kernel launches.

The plain version steps each chain in float64 from float32 values and
rounds to float32 after every step: the product of two float32 values is
exact in float64, so a step rounds as the FMA does (but for a rare double
rounding), where float32 y * a + b would round twice.

    python -m gdpt_tpu_torch.tools.fma_peak

prints the measured GFLOP/s on the card beside the published 67 TFLOP/s.
"""

import ctypes
import sys

import numpy as np
import torch

from gdpt_tpu_torch.accel import native_build
from gdpt_tpu_torch.core.dtypes import REAL
from gdpt_tpu_torch.utils import profiling

SOURCE = "fma_peak.cu"
LAUNCHES = profiling.counter_group("fma_peak.launches", {"fma_peak": 0})
# The reference's constants: a multiplier just above 1 and a small step,
# so no chain overflows or flushes to zero in 4,096 steps.
A = float(np.float32(1.0000001))
B = float(np.float32(1e-7))
# Four times the reference's 2^20 values: 2^20 threads fill the H100's
# 132 SMs in 3.9 waves, and the partial last one cost 3% of the rate.
N = 1 << 22
STEPS = 64 * 64      # the reference's K x U
UNROLL = 64          # the kernel's inner loop; steps must be a multiple
PUBLISHED_GFLOPS = 67e3  # H100 SXM f32 outside the tensor cores (data sheet)

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = native_build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gdpt_fma_peak.argtypes = [p, i, f, f, i, p, p, p, p, p]
        lib.gdpt_fma_peak.restype = i
        _lib = lib
    return _lib


def flops(n, steps=STEPS):
    """Flops of one launch: two per FMA, four chains of `steps` per value."""
    return 2 * 4 * n * steps


def block(n=N, device="cpu"):
    """The reference's block: arange(n) * 1e-9 in float32."""
    return torch.arange(n, dtype=REAL, device=device) * 1e-9


def _check(x, steps):
    if x.dtype != REAL or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("fma_peak takes a contiguous (n,) float32 tensor")
    if steps < 0 or steps % UNROLL:
        raise ValueError(f"steps must be a non-negative multiple of {UNROLL}, got {steps!r}")


def fma_peak_plain(x, a=A, b=B, steps=STEPS):
    """The kernel's four chains in plain PyTorch, for a CPU tensor x:
    (y0, y1, y2, y3), each chain stepped `steps` times."""
    _check(x, steps)
    if x.device.type != "cpu":
        raise ValueError(f"fma_peak_plain runs on cpu tensors, not {x.device}")
    chains = [x, x * a, x + b, x * a + b]
    for _ in range(steps):
        chains = [(c.double() * a + b).to(REAL) for c in chains]
    return tuple(chains)


def fma_peak(x, a=A, b=B, steps=STEPS):
    """Four FMA chains per value of x (see the module docstring). Returns
    (y0, y1, y2, y3)."""
    _check(x, steps)
    if x.device.type == "cpu":
        return fma_peak_plain(x, a, b, steps)
    if x.device.type != "cuda":
        raise ValueError(f"fma_peak runs on cuda or cpu tensors, not {x.device}")
    lib = _load()
    n = x.shape[0]
    ys = [torch.empty(n, dtype=REAL, device=x.device) for _ in range(4)]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(x.device):
        err = lib.gdpt_fma_peak(ptr(x), n, a, b, steps, *map(ptr, ys),
                                ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    LAUNCHES["fma_peak"] += n > 0
    if err != 0:
        raise RuntimeError(f"fma_peak_kernel launch failed: CUDA error {err}")
    return tuple(ys)


def time_ms(x, steps=STEPS, reps=3):
    """Least ms of one launch over `reps` launches after a warm-up, each
    timed by CUDA events."""
    if x.device.type != "cuda":
        raise ValueError("the FMA peak is timed on a CUDA device")
    fma_peak(x, steps=steps)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fma_peak(x, steps=steps)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def measure_fma_peak(n=N, steps=STEPS, device="cuda"):
    """Measured f32 FMA rate of the card, GFLOP/s."""
    x = block(n, device)
    return flops(n, steps) / (time_ms(x, steps) * 1e-3) / 1e9


def main(argv):
    from gdpt_tpu_torch.core.dtypes import resolve_device

    device = resolve_device(argv[1] if len(argv) > 1 else None)
    peak = measure_fma_peak(device=device)
    print(f"{torch.cuda.get_device_name(device)}: f32 FMA peak {peak:.1f} GFLOP/s measured, "
          f"{PUBLISHED_GFLOPS:.0f} published ({peak / PUBLISHED_GFLOPS:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
