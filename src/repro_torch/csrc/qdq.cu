// Blockwise int8 quantize-dequantize round trip over a flat tensor.
//
// Replaces: src/repro/kernels/boundary/kernel.py, `qdq_flat` / `qdq`
// (body `_qdq_kernel`, launched through `_rows_call`): the tensor is
// flattened, cut into blocks of `block` elements (the tail zero-padded),
// and each block is scaled by its absmax:
//     s = max|x|,  q = clip(rint(x / max(s, 1e-12) * 127), -127, 127),
//     y = q * s / 127      (all in f32, cast back to x's dtype)
// which is bit-for-bit `repro.compression.quant8._roundtrip`.
//
// Bound on the H100: bytes (read x once, write y once; ~5 flops/element).
//
// Design: one warp per block of 64 (two elements per lane); the absmax is a
// shuffle reduction, so no shared memory and no second pass.  The rounding
// is rintf (round half to even, as jnp.round) and the operation order is
// exactly the reference's: x / max(s, 1e-12) * 127.0f, then q * s / 127.0f.
// Built without --use_fast_math so the division is IEEE and the int8 codes
// equal the plain version's.  The optional `codes` / `scales` outputs give
// the comparison harness the codes themselves; the wire path passes null.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void qdq_kernel(const T* __restrict__ x, T* __restrict__ out,
                           int8_t* __restrict__ codes,
                           float* __restrict__ scales, int64_t n,
                           int64_t n_blocks, int block) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_blocks) return;
  const int64_t base = b * block;
  const int per_lane = block / 32;  // 2 for the paper's 64
  float v[4];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < per_lane) {
      const int64_t idx = base + i * 32 + lane;
      v[i] = idx < n ? to_f32(x[idx]) : 0.f;  // zero-padded tail
      amax = fmaxf(amax, fabsf(v[i]));
    }
  }
  amax = warp_max(amax);
  const float denom = fmaxf(amax, 1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < per_lane) {
      const int64_t idx = base + i * 32 + lane;
      float q = rintf(__fdiv_rn(v[i], denom) * 127.0f);
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      if (idx < n) {
        out[idx] = from_f32<T>(__fdiv_rn(q * amax, 127.0f));
        if (codes != nullptr) codes[idx] = (int8_t)q;
      }
    }
  }
  if (scales != nullptr && lane == 0) scales[b] = amax;
}

}  // namespace

// block must be 32, 64, 96 or 128 (a multiple of the warp width, at most
// four elements per lane).
extern "C" int repro_qdq_flat(const void* x, void* out, void* codes,
                              void* scales, int64_t n, int block, int dtype,
                              void* stream) {
  if (block <= 0 || block % 32 != 0 || block > 128)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t n_blocks = (n + block - 1) / block;
  const int64_t grid = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) {
    qdq_kernel<float><<<(unsigned)grid, 32 * kWarpsPerBlock, 0, s>>>(
        (const float*)x, (float*)out, (int8_t*)codes, (float*)scales, n,
        n_blocks, block);
  } else if (dtype == DTYPE_BF16) {
    qdq_kernel<__nv_bfloat16><<<(unsigned)grid, 32 * kWarpsPerBlock, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, (int8_t*)codes,
        (float*)scales, n, n_blocks, block);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
