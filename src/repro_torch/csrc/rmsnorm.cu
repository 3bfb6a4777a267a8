// Fused RMSNorm forward.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, `rmsnorm`
// (body `_rmsnorm_kernel`): y = x * rsqrt(mean(x^2) + eps) * scale in f32,
// cast back to x's dtype.  Plain `scale`, not `1 + scale`.
//
// Bound on the H100: bytes.  Per row of d elements it reads d inputs and
// writes d outputs and does ~4d flops, far below the card's 295 flop/byte
// balance point, so the floor is (read x + write y + read scale) over
// 3.35 TB/s.  At the families' widths (1536-5120) and 1,024 rows that is
// 2-6 us, about one wave of loads, so what a call pays beside the bytes is
// the chain from a row's first load to its last store: the DRAM round
// trip, one f32 -> f64 conversion an element (16 a clock an SM) and the
// reduction.
//
// Design: two paths, picked on the host by
// `repro_torch/kernels/rmsnorm/kernel.py::_plan` (width, dtype, alignment).
//
//   register path (`rmsnorm_rows_kernel<T, NV, W>`) — one row a block of W
//   warps (4; 8 for rows past 4 x 32 x 8 vectors), held in registers as NV
//   16-byte vectors a lane (8 bf16 or 4 f32 each), kept packed: thread t
//   holds vectors u = i 32 W + t, so a warp's i-th load covers 512
//   adjacent bytes.  x is read once (LDG.E.128), the sum of squares is
//   taken in f64 from the registers (a pairwise sum a vector, the vectors
//   in turn, a butterfly of shuffles, then one barrier and the W warp
//   sums in order), and y is written from the same registers with 16-byte
//   stores; the scale (f32, 16-byte vectors) comes from L1/L2, shared by
//   every row.  A lane's last vector is predicated where the row is not a
//   whole number of 32 W vectors (width 1600).  Four warps of few vectors
//   beat one warp a row of many at every width measured (PERF.md): a
//   row's chain is shorter, and 1,024 rows put 31 warps on an SM to hide
//   it where one warp a row put 8.
//
//   general path (`rmsnorm_general_kernel`) — widths not a multiple of the
//   16-byte vector, pointers not 16-byte aligned, rows wider than 8 warps
//   of 8 vectors: one 256-thread block a row, scalar loads, the same f64
//   sum through shared memory, and a second read of the row from L1/L2.
//
// Both paths sum the squares in f64 and round the mean once to f32, so it
// is the correctly rounded f32 value whatever the summation order (an f32
// sum differs by a few ulps between two orders at d = 4096); the plain
// version sums in f64 too, rsqrtf is the instruction torch.rsqrt uses on the
// card and the product is (x * r) * scale in f32 in both, so kernel and
// plain version agree to the bit.
#include "common.cuh"

namespace {

constexpr int kGeneralThreads = 256;

// Sum of the squares of the V elements of one packed 16-byte vector, in
// f64 (each square exact), pairwise.
template <typename T>
__device__ __forceinline__ double vec_sumsq(const uint4& w);

template <>
__device__ __forceinline__ double vec_sumsq<__nv_bfloat16>(const uint4& w) {
  float f[8];
  unpack_bf16x2(w.x, f[0], f[1]);
  unpack_bf16x2(w.y, f[2], f[3]);
  unpack_bf16x2(w.z, f[4], f[5]);
  unpack_bf16x2(w.w, f[6], f[7]);
  double s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const double a = (double)f[2 * e], b = (double)f[2 * e + 1];
    s[e] = a * a + b * b;
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

template <>
__device__ __forceinline__ double vec_sumsq<float>(const uint4& w) {
  const double a = (double)__uint_as_float(w.x);
  const double b = (double)__uint_as_float(w.y);
  const double c = (double)__uint_as_float(w.z);
  const double e = (double)__uint_as_float(w.w);
  return (a * a + b * b) + (c * c + e * e);
}

// y = (x * r) * scale for one packed vector at unit u of the row.
template <typename T>
__device__ __forceinline__ uint4 vec_norm(const uint4& w, float r,
                                          const float* __restrict__ scale,
                                          int u);

template <>
__device__ __forceinline__ uint4 vec_norm<__nv_bfloat16>(
    const uint4& w, float r, const float* __restrict__ scale, int u) {
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale) + 2 * u);
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale) + 2 * u + 1);
  float f[8];
  unpack_bf16x2(w.x, f[0], f[1]);
  unpack_bf16x2(w.y, f[2], f[3]);
  unpack_bf16x2(w.z, f[4], f[5]);
  unpack_bf16x2(w.w, f[6], f[7]);
  return make_uint4(pack_bf16x2(f[0] * r * s0.x, f[1] * r * s0.y),
                    pack_bf16x2(f[2] * r * s0.z, f[3] * r * s0.w),
                    pack_bf16x2(f[4] * r * s1.x, f[5] * r * s1.y),
                    pack_bf16x2(f[6] * r * s1.z, f[7] * r * s1.w));
}

template <>
__device__ __forceinline__ uint4 vec_norm<float>(
    const uint4& w, float r, const float* __restrict__ scale, int u) {
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale) + u);
  return make_uint4(__float_as_uint(__uint_as_float(w.x) * r * s.x),
                    __float_as_uint(__uint_as_float(w.y) * r * s.y),
                    __float_as_uint(__uint_as_float(w.z) * r * s.z),
                    __float_as_uint(__uint_as_float(w.w) * r * s.w));
}

template <typename T, int NV, int W>
__global__ void __launch_bounds__(32 * W)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ out, int d, float eps) {
  __shared__ double part[W];
  const int t = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int units = d / (16 / (int)sizeof(T));
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int u = i * 32 * W + t;
    v[i] = u < units ? __ldg(xr + u) : make_uint4(0, 0, 0, 0);
  }
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < NV; ++i) ss += vec_sumsq<T>(v[i]);
  ss = warp_sum_f64(ss);
  if ((t & 31) == 0) part[t >> 5] = ss;
  __syncthreads();
  ss = part[0];
#pragma unroll
  for (int k = 1; k < W; ++k) ss += part[k];
  const float r = rsqrtf((float)(ss / (double)d) + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int u = i * 32 * W + t;
    if (u < units) orow[u] = vec_norm<T>(v[i], r, scale, u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kGeneralThreads)
rmsnorm_general_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  double ss = 0.0;
  for (int j = threadIdx.x; j < d; j += kGeneralThreads) {
    const double v = (double)to_f32(xr[j]);
    ss += v * v;
  }
  __shared__ double part[kGeneralThreads / 32];
  ss = warp_sum_f64(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    double t = lane < kGeneralThreads / 32 ? part[lane] : 0.0;
    t = warp_sum_f64(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float var = (float)(part[0] / (double)d);
  const float r = rsqrtf(var + eps);
  for (int j = threadIdx.x; j < d; j += kGeneralThreads) {
    orow[j] = from_f32<T>(to_f32(xr[j]) * r * scale[j]);
  }
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

struct RowsArgs {
  const void* x;
  const float* scale;
  void* out;
  int64_t rows;
  int d;
  float eps;
  cudaStream_t s;
};

// Launch rmsnorm_rows_kernel<T, nv, W> for the nv in [NV, NV_MAX].
template <typename T, int W, int NV, int NV_MAX>
int launch_nv(int nv, const RowsArgs& a) {
  if constexpr (NV > NV_MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (nv != NV) return launch_nv<T, W, NV + 1, NV_MAX>(nv, a);
    rmsnorm_rows_kernel<T, NV, W><<<(unsigned)a.rows, 32 * W, 0, a.s>>>(
        (const T*)a.x, a.scale, (T*)a.out, a.d, a.eps);
    return (int)cudaGetLastError();
  }
}

// The register path's launch for (nv, w) as `_plan` gives them: 4 warps a
// row with 1-8 vectors a lane, or 8 warps with 5-8 (a row takes 8 warps
// only where 4 would need more than 8 vectors a lane).
template <typename T>
int launch_rows(const RowsArgs& a, int nv, int w) {
  constexpr int V = 16 / (int)sizeof(T);
  if (a.d % V != 0 || misaligned(a.x) || misaligned(a.scale) ||
      misaligned(a.out) || (int64_t)nv * 32 * w * V < a.d ||
      a.rows > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (w == 4) return launch_nv<T, 4, 1, 8>(nv, a);
  if (w == 8) return launch_nv<T, 8, 5, 8>(nv, a);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_general(const RowsArgs& a) {
  if (a.rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  rmsnorm_general_kernel<T><<<(unsigned)a.rows, kGeneralThreads, 0, a.s>>>(
      (const T*)a.x, a.scale, (T*)a.out, a.d, a.eps);
  return (int)cudaGetLastError();
}

}  // namespace

// `vectors` and `warps` are `_plan`'s: the register path with that many
// 16-byte vectors a lane and warps a row, or the general path for
// vectors == 0.  A plan the register path cannot take (width, alignment,
// an instantiation it lacks) is refused, never run on the other path.
extern "C" int repro_rmsnorm(const void* x, const float* scale, void* out,
                             int64_t rows, int d, float eps, int dtype,
                             int vectors, int warps, void* stream) {
  if (rows == 0) return 0;
  const RowsArgs a{x, scale, out, rows, d, eps, (cudaStream_t)stream};
  if (dtype == DTYPE_F32)
    return vectors == 0 ? launch_general<float>(a)
                        : launch_rows<float>(a, vectors, warps);
  if (dtype == DTYPE_BF16)
    return vectors == 0 ? launch_general<__nv_bfloat16>(a)
                        : launch_rows<__nv_bfloat16>(a, vectors, warps);
  return (int)cudaErrorInvalidValue;
}
