// Blockwise dynamic int8 quantization (Dettmers 2021): the two-launch pair
// that quantizes a flat tensor to int8 codes + f32 block scales and
// dequantizes them back.
//
// Replaces: src/repro/kernels/quant8/kernel.py, `quantize` (body
// `_quant_kernel`) and `dequantize` (`_dequant_kernel`).  For a flat x of
// n_blocks * block elements viewed as [n_blocks, block]:
//     s = max|x| per block,  q = clip(rint(x / max(s, 1e-12) * 127),
//     -127, 127) as int8,    y = (float)q * s / 127 cast to the output
// dtype, all in f32, which is `repro.kernels.quant8.ref` bit for bit.
//
// Bound on the H100: bytes.  quantize reads x and writes one byte per
// element plus one f32 per block (~5 flops an element); dequantize reads
// the codes and scales and writes y.
//
// Design: quantize is one warp per block of 32, 64, 96 or 128 elements
// (one to four per lane), the absmax a shuffle reduction, so no shared
// memory and one pass; lane 0 stores the scale.  The division is IEEE
// (__fdiv_rn; the library is built without --use_fast_math) and the
// rounding rintf (half to even, as jnp.round), so codes equal the plain
// version's.  dequantize is elementwise, one thread per element, in the
// plain version's order: (float)q * s, then an IEEE division by 127.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 256;

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                int8_t* __restrict__ codes,
                                float* __restrict__ scales,
                                int64_t n_blocks, int block) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_blocks) return;
  const int64_t base = b * block;
  const int per_lane = block / 32;
  float v[4];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < per_lane) {
      v[i] = to_f32(x[base + i * 32 + lane]);
      amax = fmaxf(amax, fabsf(v[i]));
    }
  }
  amax = warp_max(amax);
  const float denom = fmaxf(amax, 1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < per_lane) {
      float q = rintf(__fdiv_rn(v[i], denom) * 127.0f);
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      codes[base + i * 32 + lane] = (int8_t)q;
    }
  }
  if (lane == 0) scales[b] = amax;
}

template <typename T>
__global__ void dequantize_kernel(const int8_t* __restrict__ codes,
                                  const float* __restrict__ scales,
                                  T* __restrict__ out, int64_t n,
                                  int block) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = from_f32<T>(
        __fdiv_rn((float)codes[i] * scales[i / block], 127.0f));
  }
}

}  // namespace

// x: flat [n_blocks * block] in dtype; codes int8 [n_blocks * block];
// scales f32 [n_blocks].  block must be 32, 64, 96 or 128.
extern "C" int repro_quant8_quantize(const void* x, void* codes,
                                     void* scales, int64_t n_blocks,
                                     int block, int dtype, void* stream) {
  if (block <= 0 || block % 32 != 0 || block > 128 || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const int64_t grid = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) {
    quantize_kernel<float><<<(unsigned)grid, 32 * kWarpsPerBlock, 0, s>>>(
        (const float*)x, (int8_t*)codes, (float*)scales, n_blocks, block);
  } else if (dtype == DTYPE_BF16) {
    quantize_kernel<__nv_bfloat16>
        <<<(unsigned)grid, 32 * kWarpsPerBlock, 0, s>>>(
            (const __nv_bfloat16*)x, (int8_t*)codes, (float*)scales,
            n_blocks, block);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// codes int8 [n], scales f32 [n / block] -> out [n] in dtype.
extern "C" int repro_quant8_dequantize(const void* codes, const void* scales,
                                       void* out, int64_t n, int block,
                                       int dtype, void* stream) {
  if (block <= 0 || n < 0 || n % block != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int64_t grid = (n + kThreads - 1) / kThreads;
  if (grid > 132 * 32) grid = 132 * 32;  // grid-stride beyond that
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) {
    dequantize_kernel<float><<<(unsigned)grid, kThreads, 0, s>>>(
        (const int8_t*)codes, (const float*)scales, (float*)out, n, block);
  } else if (dtype == DTYPE_BF16) {
    dequantize_kernel<__nv_bfloat16><<<(unsigned)grid, kThreads, 0, s>>>(
        (const int8_t*)codes, (const float*)scales, (__nv_bfloat16*)out, n,
        block);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
