// Measured float32 FMA peak of the card, Hopper.
//
// Replaces the XLA loop of tools/speed_of_light.py measure_vpu_peak (not a
// Pallas kernel): four independent y = y * a + b chains over a block of
// values, `steps` fused multiply-adds a chain, whose time gives the f32
// rate that speed_of_light divides a ray's intersection flops by. On the
// TPU the loop is one fusion on a block that stays in VMEM; in eager
// PyTorch every step would be its own elementwise launch through device
// memory and would measure HBM, not arithmetic. Here each thread keeps
// its value's four chains in registers for the whole run, reads one
// float and writes four.
//
// Contract: x (n,) float32; y0..y3 (n,) float32 out, chain c of value i
// started at x[i], x[i] * a, x[i] + b and x[i] * a + b (as the
// reference's loop starts them) and stepped `steps` times by
// __fmaf_rn(y, a, b): one rounding a step.
//
// Bound on the H100 (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
// operations 2 x 4 x steps x n (the FMAs; the start-up multiplies and adds
// are not counted), bytes 20 x n. At n = 2^20 and steps = 4,096: 34.4 GFLOP
// -> 513 us, 21 MB -> 6.3 us, so it is bound by operations, as it must be
// to measure them.
//
// Design: the build passes --fmad=false to every source of the package
// (bit-exact kernels elsewhere), so the step is an explicit __fmaf_rn,
// which --fmad=false does not split. One thread a value, 256 threads a
// block: 4,096 blocks at n = 2^20, many waves of the 132 SMs. Four
// independent chains give each warp four FMAs in flight, and several warps
// per scheduler cover the FMA's latency; the inner loop is unrolled 64
// times, so the loop's own instructions are one in 256.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int UNROLL = 64;

__global__ void __launch_bounds__(BLOCK)
fma_peak_kernel(const float* __restrict__ x, int n, float a, float b, int outer,
                float* __restrict__ y0, float* __restrict__ y1, float* __restrict__ y2,
                float* __restrict__ y3) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  float c0 = v, c1 = __fmul_rn(v, a), c2 = __fadd_rn(v, b),
        c3 = __fadd_rn(__fmul_rn(v, a), b);
  for (int k = 0; k < outer; ++k) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      c0 = __fmaf_rn(c0, a, b);
      c1 = __fmaf_rn(c1, a, b);
      c2 = __fmaf_rn(c2, a, b);
      c3 = __fmaf_rn(c3, a, b);
    }
  }
  y0[i] = c0;
  y1[i] = c1;
  y2[i] = c2;
  y3[i] = c3;
}

}  // namespace

extern "C" {

// steps must be a multiple of 64. Returns cudaGetLastError() after the
// launch (0 on success).
int gdpt_fma_peak(const float* x, int n, float a, float b, int steps, float* y0, float* y1,
                  float* y2, float* y3, void* stream) {
  if (n > 0) {
    fma_peak_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
        x, n, a, b, steps / UNROLL, y0, y1, y2, y3);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
