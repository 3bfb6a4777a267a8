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
// Design.  `qdq_vec_kernel` (blocks of 32, 64 and 128): a lane holds one
// 16-byte vector of a block (8 bf16 or 4 f32), so a block is an aligned
// group of block / 8 (bf16) or block / 4 (f32) lanes, its absmax a
// shuffle reduction within the group; it stores 16-byte vectors (codes 8
// or 4 bytes a lane, the scale from the group's first lane).  One vector
// a thread in 256-thread CTAs: a full SM then has 32 KB of loads in
// flight, four times the first version's, and on the H100 this beat
// holding 2, 4 or 8 vectors a thread (more CTAs, whose loads, math and
// stores overlap across waves; PERF.md).  It takes the whole blocks; a
// partial tail block (zeros past n count for its absmax, nothing is
// stored past n) goes to `qdq_warp_kernel`, the first version's layout:
// one warp per block, block / 32 elements a lane.  A block of 96 would
// need a group of 12 or 24 lanes, so that kernel takes all of a call with
// blocks of 96.
//
// Numerics: rintf (round half to even, as jnp.round) and the reference's
// result to the bit: x / max(s, 1e-12) * 127.0f, then q * s / 127.0f,
// with IEEE divisions (built without --use_fast_math).  Two IEEE
// divisions an element (a MUFU reciprocal, its refinement and a range
// check each) bound a first vector version by instruction issue, so the
// vector kernel takes one division a lane per block (c = 127 / max(s,
// 1e-12)), gets each code from x c (`block_codes`: the division decides
// only within 2^-12 of a rounding boundary) and q s / 127 from two
// multiplies and two FMAs (`block_dequant`), both equal to the IEEE
// results (common.cuh); a rare fallback is one branch for a lane's 8 (or
// 4) values.  The optional `codes` / `scales` outputs give the comparison
// harness the codes themselves; the wire path passes null.
#include "common.cuh"

namespace {

constexpr int kVecThreads = 256;

// Whole blocks only: n_vec vectors of V elements, every one full; a block
// is an aligned group of LANES lanes.
template <typename T, int LANES, bool CODES>
__global__ void __launch_bounds__(kVecThreads)
qdq_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
               int8_t* __restrict__ codes, float* __restrict__ scales,
               int64_t n_vec) {
  constexpr int V = 16 / sizeof(T);  // elements of a vector
  const int64_t vi = (int64_t)blockIdx.x * kVecThreads + threadIdx.x;
  float v[V];
  if (vi < n_vec) {
    load_vec<V>(x + vi * V, v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) s = fmaxf(s, fabsf(v[e]));
  s = group_max(s, LANES);           // every lane of the warp calls it
  if (vi >= n_vec) return;
  float q[V], y[V];
  block_codes<V>(v, s, q);
  block_dequant<V>(q, s, y);
  store_vec<V>(out + vi * V, y);
  if constexpr (CODES) {
    store_codes<V>(codes + vi * V, q);
    if (vi % LANES == 0) scales[vi / LANES] = s;
  }
}

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void qdq_warp_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int8_t* __restrict__ codes,
                                float* __restrict__ scales, int64_t n,
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
      const int64_t idx = base + i * 32 + lane;
      v[i] = idx < n ? to_f32(x[idx]) : 0.f;  // zero-padded tail
      amax = fmaxf(amax, fabsf(v[i]));
    }
  }
  amax = warp_max(amax);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < per_lane) {
      const int64_t idx = base + i * 32 + lane;
      const float q = int8_code(v[i], amax);
      if (idx < n) {
        out[idx] = from_f32<T>(__fdiv_rn(q * amax, 127.0f));
        if (codes != nullptr) codes[idx] = (int8_t)q;
      }
    }
  }
  if (scales != nullptr && lane == 0) scales[b] = amax;
}

template <typename T>
int launch(const T* x, T* out, int8_t* codes, float* scales, int64_t n,
           int block, cudaStream_t s) {
  const int64_t n_blocks = (n + block - 1) / block;
  if (block == 96) {
    const int64_t grid = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
    qdq_warp_kernel<T><<<(unsigned)grid, 32 * kWarpsPerBlock, 0, s>>>(
        x, out, codes, scales, n, n_blocks, block);
    return (int)cudaGetLastError();
  }
  const int64_t whole = n / block;   // the vector kernel's blocks
  if (whole > 0) {
    constexpr int V = 16 / sizeof(T);
    const int64_t n_vec = whole * (block / V);
    const unsigned grid = (unsigned)((n_vec + kVecThreads - 1) / kVecThreads);
#define REPRO_QDQ_VEC(LANES)                                               \
  if (codes != nullptr)                                                    \
    qdq_vec_kernel<T, LANES, true><<<grid, kVecThreads, 0, s>>>(           \
        x, out, codes, scales, n_vec);                                     \
  else                                                                     \
    qdq_vec_kernel<T, LANES, false><<<grid, kVecThreads, 0, s>>>(          \
        x, out, nullptr, nullptr, n_vec)
    switch (block / V) {
      case 4: REPRO_QDQ_VEC(4); break;
      case 8: REPRO_QDQ_VEC(8); break;
      case 16: REPRO_QDQ_VEC(16); break;
      case 32: REPRO_QDQ_VEC(32); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_QDQ_VEC
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (whole == n_blocks) return 0;
  // the zero-padded tail block: one warp
  const int64_t e0 = whole * block;
  qdq_warp_kernel<T><<<1, 32 * kWarpsPerBlock, 0, s>>>(
      x + e0, out + e0, codes == nullptr ? nullptr : codes + e0,
      scales == nullptr ? nullptr : scales + whole, n - e0, 1, block);
  return (int)cudaGetLastError();
}

}  // namespace

// block must be 32, 64, 96 or 128; x, out and codes 16-byte aligned;
// codes and scales are both given or both null.
extern "C" int repro_qdq_flat(const void* x, void* out, void* codes,
                              void* scales, int64_t n, int block, int dtype,
                              void* stream) {
  if (block <= 0 || block % 32 != 0 || block > 128 ||
      ((uintptr_t)x | (uintptr_t)out | (uintptr_t)codes) % 16 != 0 ||
      (uintptr_t)scales % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if ((n + block - 1) / block > (int64_t)0x7fffffff * kWarpsPerBlock)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int8_t* c = (int8_t*)codes;
  float* sc = (float*)scales;
  if ((c == nullptr) != (sc == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return launch<float>((const float*)x, (float*)out, c, sc, n, block, s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>((const __nv_bfloat16*)x,
                                 (__nv_bfloat16*)out, c, sc, n, block, s);
  return (int)cudaErrorInvalidValue;
}
