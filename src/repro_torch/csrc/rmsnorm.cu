// Fused RMSNorm forward.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, `rmsnorm`
// (body `_rmsnorm_kernel`): y = x * rsqrt(mean(x^2) + eps) * scale in f32,
// cast back to x's dtype.  Plain `scale`, not `1 + scale`.
//
// Bound on the H100: bytes.  Per row of d elements it reads d inputs and
// writes d outputs and does ~4d flops, far below the card's 295 flop/byte
// balance point, so the floor is (read x + write y + read scale) over
// 3.35 TB/s.
//
// Design: one 256-thread block per row.  Pass 1 accumulates the sum of
// squares in f64 (per-thread strided partial sums, then warp shuffles and a
// 8-entry shared array), pass 2 re-reads the row (now in L1/L2) and writes
// x * r * scale in f32.  The unfused PyTorch version writes an f32 copy of
// the activation and reads it back; this kernel touches the activation once
// from device memory.  Summing in f64 makes the row's mean square the
// correctly rounded f32 value whatever the summation order, and the plain
// version sums in f64 too; rsqrtf is the instruction torch.rsqrt uses on
// the card, so the two agree to the bit (an f32 sum differs by a few ulps
// between any two summation orders at d = 4096).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  double ss = 0.0;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const double v = (double)to_f32(xr[j]);
    ss += v * v;
  }
  __shared__ double part[kThreads / 32];
  ss = warp_sum_f64(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    double t = lane < kThreads / 32 ? part[lane] : 0.0;
    t = warp_sum_f64(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float var = (float)(part[0] / (double)d);
  const float r = rsqrtf(var + eps);
  for (int j = threadIdx.x; j < d; j += kThreads) {
    orow[j] = from_f32<T>(to_f32(xr[j]) * r * scale[j]);
  }
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const float* scale, void* out,
                             int64_t rows, int d, float eps, int dtype,
                             void* stream) {
  if (rows == 0) return 0;
  dim3 grid((unsigned)rows);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) {
    rmsnorm_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, scale, (float*)out, d, eps);
  } else if (dtype == DTYPE_BF16) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, scale, (__nv_bfloat16*)out, d, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
