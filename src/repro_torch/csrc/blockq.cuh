// Blockwise int8 quantization of a flat tensor, the kernels behind
// qdq.cu (the round trip) and quant8.cu (quantize, dequantize).
//
// A flat x is cut into blocks of `block` elements and each block is
// scaled by its absmax:
//     s = max|x|,  q = clip(rint(x / max(s, 1e-12) * 127), -127, 127),
//     y = q * s / 127      (all in f32, y cast back to x's dtype)
// bit for bit `repro.compression.quant8`'s blockwise_quantize /
// _roundtrip.  Bound on the H100: bytes (~5 flops an element).
//
// Paths.  Which one takes a call is decided by one rule in Python,
// `kernels/boundary/kernel.py::flat_block_path`, and handed down as
// `path`:
//   LANES  — every pointer 16-byte aligned and the block a power of two
//            of 1 to 32 vectors (bf16 8 ... 256, f32 4 ... 128).  A lane
//            holds one 16-byte vector (8 bf16 or 4 f32); a block is an
//            aligned group of lanes whose absmax is a shuffle reduction
//            (`group_max`); one vector a thread in 256-thread CTAs (on
//            the H100 this beat 2, 4 and 8 vectors a thread for qdq:
//            more CTAs, whose loads, math and stores overlap across
//            waves; PERF.md).  Dequantize: a lane takes the codes of one
//            16-byte output vector (8 bf16 or 4 f32, one 8- or 4-byte
//            load; 16 codes a lane were slower) and reads its block's
//            scale once.
//   UNITS  — every pointer 16-byte aligned and the block a whole number
//            of vectors (48, 96, 192, 512, 4096, ...): a group of `tpb`
//            threads (a power of two, 1 to 256) a block, each looping
//            over about four of the block's vectors (four beat one and
//            two on the H100; holding them in registers did not beat
//            reading them again); the group's absmax by shuffles,
//            through shared memory past a warp; the codes in a second
//            pass over the same vectors (from L1).
//   SCALAR — anything else (blocks 1, 3, 100, unaligned views, the
//            zero-padded tail block of qdq_flat): the UNITS layout one
//            element at a time.
// Numerics: one IEEE division a block (c = 127 / max(s, 1e-12)), the
// codes from x c (`flat_codes`, the guard of `block_codes`), q s / 127
// from two multiplies and two FMAs (`block_dequant`), all equal to the
// IEEE results (common.cuh); rounding half to even, as jnp.round; a code
// of 0 dequantizes to +0, as through int8.
#pragma once

#include "common.cuh"

#define BLOCKQ_SCALAR 0
#define BLOCKQ_UNITS 1
#define BLOCKQ_LANES 2

// Each including source gets its own copy (the anonymous namespace): qdq.cu
// and quant8.cu instantiate different kernels, and no symbol is shared.
namespace {
namespace blockq {

constexpr int kThreads = 256;

template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }

constexpr float kShift = 0x1.8p23f;    // 1.5 2^23

// c = 127 / max(s, 1e-12), the block's one IEEE division.
__device__ __forceinline__ float block_code_scale(float s) {
  return __fdiv_rn(127.0f, fmaxf(s, 1e-12f));
}

// The codes of N values of one block (absmax s, c = 127 / max(s, 1e-12))
// as the int8 round trip has them: q[e] the code as f32 (+0 for 0) and
// bits[e] a word whose low byte is the code.  t = v c rounds to an
// integer by adding 1.5 2^23 (round half to even: rint), whose low
// mantissa byte is then the code in two's complement; no clamp, as
// |t| <= 127 (1 + u)^2 < 127.5.  This takes two adds where rintf and the
// int conversion are quarter-rate instructions on the H100 (PERF.md: it
// took 12 % off quantize there).  As in `block_codes`, a t within 2^-12
// of a half-integer takes the IEEE division.
template <int N>
__device__ __forceinline__ void flat_codes(const float* v, float s, float c,
                                           float* q, uint32_t* bits) {
  bool near_tie = false;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float t = __fmul_rn(v[e], c);
    const float r = __fadd_rn(t, kShift);
    bits[e] = __float_as_uint(r);
    q[e] = __fsub_rn(r, kShift);
    near_tie |= fabsf(t - q[e]) > 0.5f - 0x1p-12f;
  }
  if (near_tie) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float r = __fadd_rn(int8_code_ieee(v[e], s), kShift);
      bits[e] = __float_as_uint(r);
      q[e] = __fsub_rn(r, kShift);
    }
  }
}

// The low bytes of b[0, N) at p, in one store of N bytes (p aligned to
// N bytes).
template <int N>
__device__ __forceinline__ void store_code_bytes(int8_t* p,
                                                 const uint32_t* b) {
  static_assert(N == 1 || N == 4 || N == 8, "1, 4 or 8 codes");
  if constexpr (N == 1) {
    *p = (int8_t)(b[0] & 0xffu);
  } else {
    uint32_t w[N / 4];
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      w[k] = __byte_perm(__byte_perm(b[4 * k], b[4 * k + 1], 0x0040),
                         __byte_perm(b[4 * k + 2], b[4 * k + 3], 0x0040),
                         0x5410);
    if constexpr (N == 4)
      *reinterpret_cast<uint32_t*>(p) = w[0];
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// ---- LANES: a block is an aligned group of LANES lanes ----------------
// Whole blocks only: n_vec vectors of V elements.  CODES writes codes and
// scales, OUT the round trip's values.
template <typename T, int LANES, bool CODES, bool OUT>
__global__ void __launch_bounds__(kThreads)
blockq_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
                  int8_t* __restrict__ codes, float* __restrict__ scales,
                  int64_t n_vec) {
  constexpr int V = vec_elems<T>();
  const int64_t vi = (int64_t)blockIdx.x * kThreads + threadIdx.x;
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
  float q[V];
  uint32_t bits[V];
  flat_codes<V>(v, s, block_code_scale(s), q, bits);
  if constexpr (OUT) {
    block_dequant<V>(q, s, q);
    store_vec<V>(out + vi * V, q);
  }
  if constexpr (CODES) {
    store_code_bytes<V>(codes + vi * V, bits);
    if (vi % LANES == 0) scales[vi / LANES] = s;
  }
}

// A lane a 16-byte output vector of V values (the block a power-of-two
// number of them): one load of V codes, the block's scale read once (a
// shift, no division), one 16-byte store.
template <typename T>
__global__ void __launch_bounds__(kThreads)
blockdq_vec_kernel(const int8_t* __restrict__ codes,
                   const float* __restrict__ scales, T* __restrict__ out,
                   int64_t n_vec, int lg_lanes) {
  constexpr int V = vec_elems<T>();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  float q[V];
  load_codes<V>(codes + i * V, q);
  block_dequant<V>(q, __ldg(scales + (i >> lg_lanes)), q);
  store_vec<V>(out + i * V, q);
}

// ---- UNITS and SCALAR: a group of 2^lg threads a block ----------------
// Units of U elements (U = V: 16-byte vectors, or 1).  Threads of a group
// take units t, t + tpb, ... of their block.
template <typename T, int U>
__device__ __forceinline__ void load_unit(const T* p, float* v) {
  if constexpr (U == 1)
    v[0] = to_f32(__ldg(p));
  else
    load_vec<U>(p, v);
}

template <typename T, int U>
__device__ __forceinline__ void store_unit(T* p, const float* y) {
  if constexpr (U == 1)
    *p = from_f32<T>(y[0]);
  else
    store_vec<U>(p, y);
}

// Blocks [0, n_blocks) of x, the last ending at n (the elements past n,
// only ever in the last block and only with U = 1, count as zeros and
// nothing is stored for them).
template <typename T, int U, bool CODES, bool OUT>
__global__ void __launch_bounds__(kThreads)
blockq_gen_kernel(const T* __restrict__ x, T* __restrict__ out,
                  int8_t* __restrict__ codes, float* __restrict__ scales,
                  int64_t n, int64_t n_blocks, int block, int lg) {
  __shared__ float part[kThreads / 32];
  const int tpb = 1 << lg;
  const int t = threadIdx.x & (tpb - 1);
  const int64_t b = ((int64_t)blockIdx.x << (8 - lg)) + (threadIdx.x >> lg);
  const bool live = b < n_blocks;
  const int64_t base = b * block;
  const int len = !live ? 0 : n - base < block ? (int)(n - base) : block;
  float s = 0.f;
  for (int e = t * U; e < len; e += tpb * U) {
    float v[U];
    load_unit<T, U>(x + base + e, v);
#pragma unroll
    for (int i = 0; i < U; ++i) s = fmaxf(s, fabsf(v[i]));
  }
  if (tpb <= 32) {
    s = group_max(s, tpb);
  } else {                           // whole warps: through shared memory
    s = warp_max(s);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    const int w0 = (threadIdx.x >> lg) << (lg - 5);
    for (int w = 0; w < tpb >> 5; ++w) s = fmaxf(s, part[w0 + w]);
  }
  if (!live) return;
  const float c = block_code_scale(s);
  for (int e = t * U; e < len; e += tpb * U) {
    float v[U], q[U];
    uint32_t bits[U];
    load_unit<T, U>(x + base + e, v);
    flat_codes<U>(v, s, c, q, bits);
    if constexpr (OUT) {
      block_dequant<U>(q, s, q);
      store_unit<T, U>(out + base + e, q);
    }
    if constexpr (CODES) store_code_bytes<U>(codes + base + e, bits);
  }
  if (CODES && t == 0) scales[b] = s;
}

template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
blockdq_gen_kernel(const int8_t* __restrict__ codes,
                   const float* __restrict__ scales, T* __restrict__ out,
                   int64_t n_blocks, int block, int lg) {
  const int tpb = 1 << lg;
  const int t = threadIdx.x & (tpb - 1);
  const int64_t b = ((int64_t)blockIdx.x << (8 - lg)) + (threadIdx.x >> lg);
  if (b >= n_blocks) return;
  const int64_t base = b * block;
  const float s = __ldg(scales + b);
  for (int e = t * U; e < block; e += tpb * U) {
    float q[U];
    if constexpr (U == 1)
      q[0] = (float)__ldg(codes + base + e);
    else
      load_codes<U>(codes + base + e, q);
    block_dequant<U>(q, s, q);
    store_unit<T, U>(out + base + e, q);
  }
}

// Threads a block for the UNITS / SCALAR layouts: about four units a
// thread, at most 256 (96 bf16: 4 threads of 3 vectors; 4096: 128).
inline int group_lg(int block, int unit) {
  const int64_t want = ((int64_t)block + 4 * unit - 1) / (4 * unit);
  int lg = 0;
  while (lg < 8 && ((int64_t)1 << lg) < want) ++lg;
  return lg;
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

inline int ilog2(int64_t v) {
  int lg = 0;
  while (((int64_t)1 << lg) < v) ++lg;
  return lg;
}

// Quantize (CODES: codes + scales; OUT: the round trip's values) the
// n_blocks blocks of x, the last ending at n, on `path`; LANES and UNITS
// take whole blocks of aligned data only.
template <typename T, bool CODES, bool OUT>
int quantize(const T* x, T* out, int8_t* codes, float* scales, int64_t n,
             int64_t n_blocks, int block, int path, cudaStream_t st) {
  constexpr int V = vec_elems<T>();
  if (n_blocks == 0) return 0;
  const bool whole = n == n_blocks * block;
  if (path == BLOCKQ_LANES) {
    const int64_t lanes = block / V;
    if (!whole || block % V || lanes > 32 || (lanes & (lanes - 1)) ||
        !aligned16(x) || (OUT && !aligned16(out)) ||
        (CODES && !aligned16(codes)))
      return (int)cudaErrorInvalidValue;
    const int64_t n_vec = n / V;
    const int64_t grid = (n_vec + kThreads - 1) / kThreads;
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
#define REPRO_BLOCKQ_VEC(L)                                                 \
  case L:                                                                   \
    blockq_vec_kernel<T, L, CODES, OUT>                                     \
        <<<(unsigned)grid, kThreads, 0, st>>>(x, out, codes, scales, n_vec); \
    break;
    switch (lanes) {
      REPRO_BLOCKQ_VEC(1)
      REPRO_BLOCKQ_VEC(2)
      REPRO_BLOCKQ_VEC(4)
      REPRO_BLOCKQ_VEC(8)
      REPRO_BLOCKQ_VEC(16)
      REPRO_BLOCKQ_VEC(32)
      default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_BLOCKQ_VEC
    return (int)cudaGetLastError();
  }
  const bool units = path == BLOCKQ_UNITS;
  if (units && (!whole || block % V || !aligned16(x) ||
                (OUT && !aligned16(out)) || (CODES && !aligned16(codes))))
    return (int)cudaErrorInvalidValue;
  if (path != BLOCKQ_UNITS && path != BLOCKQ_SCALAR)
    return (int)cudaErrorInvalidValue;
  const int lg = group_lg(block, units ? V : 1);
  const int64_t grid = (n_blocks + (kThreads >> lg) - 1) >> (8 - lg);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (units)
    blockq_gen_kernel<T, V, CODES, OUT><<<(unsigned)grid, kThreads, 0, st>>>(
        x, out, codes, scales, n, n_blocks, block, lg);
  else
    blockq_gen_kernel<T, 1, CODES, OUT><<<(unsigned)grid, kThreads, 0, st>>>(
        x, out, codes, scales, n, n_blocks, block, lg);
  return (int)cudaGetLastError();
}

// out [n_blocks * block] = codes * scales / 127 in T, on `path`.
template <typename T>
int dequantize(const int8_t* codes, const float* scales, T* out,
               int64_t n_blocks, int block, int path, cudaStream_t st) {
  constexpr int V = vec_elems<T>();
  if (n_blocks == 0) return 0;
  const int64_t n = n_blocks * block;
  if (path == BLOCKQ_LANES) {
    if (block % V || block / V > 32 || (block & (block - 1)) ||
        !aligned16(codes) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    const int64_t n_vec = n / V;
    const int64_t grid = (n_vec + kThreads - 1) / kThreads;
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
    blockdq_vec_kernel<T><<<(unsigned)grid, kThreads, 0, st>>>(
        codes, scales, out, n_vec, ilog2(block / V));
    return (int)cudaGetLastError();
  }
  const bool units = path == BLOCKQ_UNITS;
  if (units && (block % V || !aligned16(codes) || !aligned16(out)))
    return (int)cudaErrorInvalidValue;
  if (path != BLOCKQ_UNITS && path != BLOCKQ_SCALAR)
    return (int)cudaErrorInvalidValue;
  const int lg = group_lg(block, units ? V : 1);
  const int64_t grid = (n_blocks + (kThreads >> lg) - 1) >> (8 - lg);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (units)
    blockdq_gen_kernel<T, V><<<(unsigned)grid, kThreads, 0, st>>>(
        codes, scales, out, n_blocks, block, lg);
  else
    blockdq_gen_kernel<T, 1><<<(unsigned)grid, kThreads, 0, st>>>(
        codes, scales, out, n_blocks, block, lg);
  return (int)cudaGetLastError();
}

}  // namespace blockq
}  // namespace
