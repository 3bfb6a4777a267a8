// Learned boundary codecs: the fused encode (+ optional wire QDQ) and
// decode of a SWARM stage crossing, and their true-wire-format pair that
// encodes straight to int8 codes + f32 scales and decodes from them.
//
// Replaces: src/repro/kernels/boundary/kernel.py, `encode` (bodies
// `_encode_kernel`, `_encode_nw_kernel`), `decode` (`_decode_kernel`),
// `encode_quantize` (`_encode_quant_kernel`, `_encode_quant_nw_kernel`)
// and `dequantize_decode` (`_dequant_decode_kernel`).
// Rows are flattened (batch x seq) tokens.  Dtype discipline, exactly as
// `_encode32` / `_decode32` and the plain versions in
// repro_torch/kernels/boundary/ref.py:
//   LN core in f32, `(x - mu) * rsqrt(var + 1e-6)`, no affine; the two
//   means are summed in f64 and rounded once (the plain version does the
//   same, so both get the correctly rounded f32 means and agree to the
//   bit); LN output rounded to the activation dtype T;
//   product: T operands (the f32 weight rounded to T on load, RNE as
//   `.to(torch.bfloat16)`), f32 accumulation, result rounded to T before
//   the second LN; output T.
//   maxout: max over k adjacent features of the T-rounded LN output.
//   QDQ (optional, row-blocked, block qb): rintf, x / max(s,1e-12) * 127,
//   q * s / 127, equal to IEEE divisions (no --use_fast_math), by one
//   division a block (`block_codes`, `block_dequant`), as qdq.cu.
//   Codes (encode_quantize): the same per-block absmax s and code q of the
//   T-rounded encode output (as `_quant32` of `_encode32(..)` upcast),
//   stored as int8 q and f32 s instead of q * s / 127.
//   Dequantize (dequantize_decode): q * s / 127 in f32, rounded to the
//   output dtype T, then (maxout) LN, then the product in T.
//
// Bound on the H100: operations for the bottleneck product
// ([1024,4096] x [4096,1024] is 8.6 GFLOP against 10.5 MB moved), bytes
// for the LN / maxout / QDQ row passes.  With the product on the tensor
// cores, re-reading the f32 weight from L2 once per row tile and rounding
// it per tile cost more than one pass that writes it once as bf16.
//
// Design.  The second LN needs whole c-wide rows, which a GEMM tile does
// not hold (64 rows x 1024 f32 accumulators are 256 KB), so a call is a
// chain of launches:
//   ln_rows  — the row in registers (namespace `rowpass`): `tpr` threads a
//              row, each holding units of 8 adjacent elements as f32,
//              read and written once with 16-byte accesses; LN from the
//              registers (f64 partial sums, shuffles, one shared-memory
//              exchange across the row's warps), round to T, optional
//              maxout pool, optional row-blocked QDQ or codes by lane
//              groups: a block of qb values on an aligned group of
//              lanes, its absmax a shuffle reduction, every lane
//              encoding its own values.  Rows of up to 1024 elements
//              take one warp (32 elements a thread) and share a
//              128-thread CTA, except with QDQ or codes (128 threads a
//              row); the thread count of a row follows from its width
//              and pass alone.
//   gemm, bf16 (tensor cores) — C[n,m] = A[n,k] x round_bf16(W[k,m]),
//              two launches (three with a split-K sum):
//              `round_wt_kernel` rounds the f32 master weight to a bf16,
//              transposed copy (RNE, as `__float2bfloat16_rn`) in the
//              wrapper's scratch tensor: its rows are the K-major B
//              operand, and wgmma reads bf16 only;
//              `codec_gemm_wgmma_kernel` computes 128x128 output tiles
//              with two warpgroups of 64 rows, `wgmma.m64n128k16` (bf16
//              operands, f32 accumulation) on A and B tiles in shared
//              memory, K-major with 128-byte swizzle, k-steps of 64 in a
//              3-stage ring of 16-byte `cp.async` copies by all 256
//              threads (two blocks an SM); the epilogue rounds to bf16
//              and stores 16 bytes per thread through shared memory.
//              Split-K (`gemm_splits`, chosen from (k, m) only, never
//              from n, so a row's result and each element's summation
//              order do not depend on the row count): the 64 tiles of
//              encode's [1024,4096]x[4096,1024] would fill half the
//              card, so there 4 splits write f32 partials to the scratch
//              and `splitk_sum_kernel` adds them in split order (no
//              atomics) and rounds to bf16.  Needs k and m multiples of
//              8 and 16-byte-aligned a and w (the wrapper checks).
//   gemm, f32 (`gemm_kernel`, SIMT) — 64x64 output tiles, k-steps of 16
//              staged in shared memory, 4x4 outputs per thread in f32 FMA
//              registers: TF32 would break the f32 path's 1e-4 bound.
//   dequant_rows — the same layout, units of 16 codes (8 where the
//              width is not a multiple of 16): codes * scale / 127, round
//              to T, optional LN in registers, write T.
// The row passes move each byte once; what held the first version (one
// block per row staged in shared memory, 2-byte accesses, three sweeps,
// one thread per QDQ block) was memory in flight and serial chains.
// They need 16-byte-aligned rows, widths a multiple of 8 (at most
// 32768), k in {1, 2, 4, 8} and qb a multiple of 8 (the wrappers check).
// encode bottleneck = ln_rows(x) -> gemm(w_c) -> ln_rows(+QDQ);
// encode maxout     = ln_rows(x, pool k, +QDQ);
// decode bottleneck = gemm(w_d); decode maxout = ln_rows(z) -> gemm(w_d);
// encode_quantize   = the encode passes, the last ln_rows emitting codes;
// dequantize_decode = dequant_rows(+LN for maxout) -> gemm(w_d).
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// ------------------------------------------------ row passes (registers)
// A row of `width` elements is cut into units of U consecutive elements
// (8 for ln_rows; 16 codes, or 8 where the width is not a multiple of
// 16, for dequant_rows).  Each row has `tpr` threads (a multiple of 32);
// thread t holds units u = i * tpr + t, i < NU, as f32 registers for the
// whole pass, so a warp's i-th loads cover 32 adjacent units (16-byte
// loads and stores, coalesced) and no element goes through shared
// memory.  Rows of few threads share a CTA.
namespace rowpass {

constexpr int kMaxThreads = 512;     // threads per row (and per CTA)
constexpr int kCtaThreads = 128;     // CTA size for rows of fewer threads

struct Plan {
  int tpr, nu;                       // threads per row, units per thread
};

// Rows of up to 32 elements a thread take one warp; wider rows hold 32
// elements a thread (64 past 16384), at most 512 threads: up to 32768
// elements.  With QDQ or codes (`blocks`), rows of up to 512 units take
// 128 threads (fewer for narrower rows), at most 4 units each: their
// per-unit work is longer, and on the H100 one warp a 1024-wide row took
// 1.3 times as long as 128 threads (PERF.md).  A function of the width
// and the pass alone, so the summation order of a row never depends on
// the row count.
inline bool plan_for(int units, int U, bool blocks, Plan* p) {
  if (blocks && units <= 512) {
    const int tpr = units <= 128 ? (units + 31) / 32 * 32 : 128;
    int n = 1;
    while (tpr * n < units) n *= 2;
    *p = {tpr, n};
    return true;
  }
  const int base = 32 / U;           // units of 32 elements
  if (units <= 32 * base) {
    int n = 1;
    while (32 * n < units) n *= 2;
    *p = {32, n};
    return true;
  }
  for (int nu = base; nu <= 2 * base; nu *= 2) {
    const int tpr = ((units + nu - 1) / nu + 31) / 32 * 32;
    if (tpr <= kMaxThreads) {
      *p = {tpr, nu};
      return true;
    }
  }
  return false;
}

// Sum over the tpr threads of each row of the CTA of one f64 value per
// thread, in a fixed order; every thread gets its row's total.  `part`
// holds a value per warp and is used once per kernel.
__device__ __forceinline__ double row_sum(double v, int tpr, double* part) {
  v = warp_sum_f64(v);
  if (tpr == 32) return v;
  const int warp = threadIdx.x >> 5, wpr = tpr >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  const int w0 = warp / wpr * wpr;   // first warp of this row
  double s = 0.0;
  for (int i = 0; i < wpr; ++i) s += part[w0 + i];
  return s;
}

template <int U>
__device__ __forceinline__ double sum_f64(const float* v) {
  double s[U];
#pragma unroll
  for (int e = 0; e < U; ++e) s[e] = (double)v[e];
#pragma unroll
  for (int h = 1; h < U; h <<= 1)
#pragma unroll
    for (int e = 0; e < U; e += 2 * h) s[e] += s[e + h];
  return s[0];
}

// In place over the units of a row held in registers (unit i valid when
// bit i of `valid` is set; every thread of the CTA calls it):
// v = round_T(LN(v)), the LN core in f32, `(x - mu) * rsqrt(var +
// 1e-6)`, its two means summed in f64 and rounded once to f32, the
// variance summing the f32 squares of (x - mu).
template <typename T, int NU, int U>
__device__ __forceinline__ void ln_regs(float (&v)[NU][U], unsigned valid,
                                        int width, int tpr,
                                        double (&part)[2][kMaxThreads / 32]) {
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < NU; ++i)
    if (valid >> i & 1u) s += sum_f64<U>(v[i]);
  s = row_sum(s, tpr, part[0]);
  const float mu = (float)(s / (double)width);
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    if (!(valid >> i & 1u)) continue;
    float sq[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const float d = v[i][e] - mu;
      sq[e] = d * d;                 // f32 square, as (x - mu) ** 2
    }
    ss += sum_f64<U>(sq);
  }
  ss = row_sum(ss, tpr, part[1]);
  const float var = (float)(ss / (double)width);
  const float rstd = rsqrtf(var + 1e-6f);
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int e = 0; e < U; ++e) v[i][e] = round_to<T>((v[i][e] - mu) * rstd);
}

// Max over windows of K adjacent values of a unit of 8, in place: the
// first 8 / K values become the windows' maxima.
template <int K>
__device__ __forceinline__ void pool_unit(float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8 / K; ++e) {
    float m = v[e * K];
#pragma unroll
    for (int j = 1; j < K; ++j) m = fmaxf(m, v[e * K + j]);
    v[e] = m;
  }
}

// Row pass of the encode: LN -> round to T -> optional maxout pool of K
// -> either T output (optionally QDQ'd in blocks of qb) or, with `codes`
// non-null, int8 codes and f32 block scales of blocks of qb.  K = 0 is the
// LN alone (no pool, no blocks).  A block of qb pooled values is held by
// L = qb K / 8 adjacent units: where L is a power of two up to 32 they
// sit on an aligned group of L lanes and the block's absmax is a shuffle
// reduction in the group; otherwise each unit's max goes through shared
// memory (`cmax`, cta * NU floats) and every thread reads its block's L
// maxima.  Every lane encodes its own values; the block's first unit
// writes its scale.
template <typename T, int NU, int K>
__global__ void __launch_bounds__(kMaxThreads)
ln_rows_kernel(const T* __restrict__ x, T* __restrict__ out,
               int8_t* __restrict__ codes, float* __restrict__ scales,
               int64_t rows, int width, int qb, int tpr) {
  __shared__ double part[2][kMaxThreads / 32];
  extern __shared__ float cmax[];
  const int t = threadIdx.x % tpr;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / tpr) +
                    threadIdx.x / tpr;
  const int units = width >> 3;
  unsigned valid = 0;
  float v[NU][8];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int u = i * tpr + t;
    if (r < rows && u < units) {
      valid |= 1u << i;
      load_vec<8>(x + r * width + 8 * u, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = 0.f;
    }
  }
  ln_regs<T, NU, 8>(v, valid, width, tpr, part);
  if constexpr (K == 0) {
#pragma unroll
    for (int i = 0; i < NU; ++i)
      if (valid >> i & 1u)
        store_vec<8>(out + r * width + 8 * (i * tpr + t), v[i]);
    return;
  } else {
    constexpr int P = 8 / K;         // pooled values of a unit
    const int64_t wout = width / K;
#pragma unroll
    for (int i = 0; i < NU; ++i) pool_unit<K>(v[i]);
    if (qb <= 0) {
#pragma unroll
      for (int i = 0; i < NU; ++i)
        if (valid >> i & 1u)
          store_vec<P>(out + r * wout + (int64_t)(i * tpr + t) * P, v[i]);
      return;
    }
    const int L = qb * K / 8;        // units of a block
    float amax[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < P; ++e) a = fmaxf(a, fabsf(v[i][e]));
      amax[i] = a;
    }
    if (L <= 32 && (L & (L - 1)) == 0) {
#pragma unroll
      for (int i = 0; i < NU; ++i) amax[i] = group_max(amax[i], L);
    } else {
      float* cm = cmax + (threadIdx.x - t) * NU;   // this row's units
#pragma unroll
      for (int i = 0; i < NU; ++i) cm[i * tpr + t] = amax[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if (!(valid >> i & 1u)) continue;
        const int b0 = (i * tpr + t) / L * L;
        float a = 0.f;
        for (int j = 0; j < L; ++j) a = fmaxf(a, cm[b0 + j]);
        amax[i] = a;
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      if (!(valid >> i & 1u)) continue;
      const int u = i * tpr + t;
      float q[P];
      block_codes<P>(v[i], amax[i], q);
      if (codes != nullptr) {
        store_codes<P>(codes + r * wout + (int64_t)u * P, q);
        if (u % L == 0) scales[r * (wout / qb) + u / L] = amax[i];
      } else {
        block_dequant<P>(q, amax[i], q);
        store_vec<P>(out + r * wout + (int64_t)u * P, q);
      }
    }
  }
}

// Row pass of dequantize_decode: z = round_T(q * s / 127) (f32, equal to
// the IEEE division, `block_dequant`; qb a multiple of 8, so each 8 codes
// share a scale), then round_T(LN(z)) when `ln`, written as T.  Units of
// U codes (one 8- or 16-byte load).
template <typename T, int NU, int U>
__global__ void __launch_bounds__(kMaxThreads)
dequant_rows_kernel(const int8_t* __restrict__ codes,
                    const float* __restrict__ scales, T* __restrict__ out,
                    int64_t rows, int width, int qb, int ln, int tpr) {
  __shared__ double part[2][kMaxThreads / 32];
  const int t = threadIdx.x % tpr;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / tpr) +
                    threadIdx.x / tpr;
  const int units = width / U;
  const float* srow = scales + r * (width / qb);
  unsigned valid = 0;
  float v[NU][U];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int u = i * tpr + t;
    if (r < rows && u < units) {
      valid |= 1u << i;
      load_codes<U>(codes + r * width + (int64_t)U * u, v[i]);
#pragma unroll
      for (int h = 0; h < U / 8; ++h) {
        float* z = v[i] + 8 * h;     // 8 codes of one block
        block_dequant<8>(z, __ldg(srow + (U * u + 8 * h) / qb), z);
#pragma unroll
        for (int e = 0; e < 8; ++e) z[e] = round_to<T>(z[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < U; ++e) v[i][e] = 0.f;
    }
  }
  if (ln) ln_regs<T, NU, U>(v, valid, width, tpr, part);
#pragma unroll
  for (int i = 0; i < NU; ++i)
    if (valid >> i & 1u)
      store_vec<U>(out + r * width + (int64_t)U * (i * tpr + t), v[i]);
}

}  // namespace rowpass

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);  // 256

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ a, const float* __restrict__ w,
            T* __restrict__ c, int n, int kdim, int m) {
  __shared__ float As[BK][BM + 4];   // A tile, transposed: As[k][row]
  __shared__ float Ws[BK][BN + 4];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kGemmThreads) {
      const int rr = i / BK, kk = i % BK;
      const int gr = row0 + rr, gk = k0 + kk;
      As[kk][rr] = (gr < n && gk < kdim)
                       ? to_f32(a[(int64_t)gr * kdim + gk]) : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += kGemmThreads) {
      const int kk = i / BN, cc = i % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      Ws[kk][cc] = (gk < kdim && gc < m)
                       ? round_to<T>(w[(int64_t)gk * m + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < m) c[(int64_t)gr * m + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

// ------------------------------------------------ bf16 GEMM: tensor cores
namespace tc {

constexpr int BM = 128, BN = 128;    // output tile
constexpr int BK = 64;               // k per stage: one 128-byte row
constexpr int STAGES = 3;
constexpr int kThreads = 256;        // two consumer warpgroups
constexpr int TILE = 128 * 128;      // bytes of one A or B stage
constexpr size_t SMEM = (size_t)STAGES * 2 * TILE + 1024;  // + alignment

// wt = round_bf16(w)^T (RNE, as __float2bfloat16_rn): w f32 [kdim, m]
// row-major -> wt bf16 [m, kdim], the K-major rows of the B operand.
// 64x64 tiles through shared memory: float4 loads along m, 16-byte
// stores of 8 k along a row of wt.  kdim and m are multiples of 8.
__global__ void __launch_bounds__(256)
round_wt_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ wt,
                int kdim, int m) {
  __shared__ float tile[64][65];     // [k][m]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tid / 16 + 16 * i, c = (tid % 16) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + r < kdim && m0 + c < m)
      v = *reinterpret_cast<const float4*>(w + (int64_t)(k0 + r) * m + m0 + c);
    tile[r][c] = v.x;
    tile[r][c + 1] = v.y;
    tile[r][c + 2] = v.z;
    tile[r][c + 3] = v.w;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tid / 8 + 32 * i, kc = (tid % 8) * 8;  // row of wt, k
    if (m0 + r < m && k0 + kc < kdim) {
      uint32_t p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = pack_bf16x2(tile[kc + 2 * e][r], tile[kc + 2 * e + 1][r]);
      *reinterpret_cast<uint4*>(wt + (int64_t)(m0 + r) * kdim + k0 + kc) =
          make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
}

// C tile [128 x 128] = A [128 rows, k] x W [k, 128 columns], by two
// warpgroups of 64 rows: per k-step of 64, four wgmma.m64n128k16 with A
// and B (= wt rows) K-major in shared memory, 128-byte swizzled.
__global__ void __launch_bounds__(kThreads)
codec_gemm_wgmma_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ wt,
                        __nv_bfloat16* __restrict__ c, float* __restrict__ ws,
                        int n, int kdim, int m, int kps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = smem_raw + ((1024 - ((uint32_t)__cvta_generic_to_shared(
                                               smem_raw) & 1023)) & 1023);
  unsigned char* sB = sA + STAGES * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2, wr = warp & 3;   // warpgroup, warp in it
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kps;
  const int kend = min(kdim, kbeg + kps);
  const int ntiles = (kend - kbeg + BK - 1) / BK;

  // Copy roles, fixed for the k loop: chunk j (of 4) of this thread is row
  // tid/8 + 32 j of the A stage (rows of a) and of the B stage (rows of
  // wt, i.e. columns of C), 16-byte k chunk tid%8, stored at chunk
  // (tid%8) ^ (row%8) of its 128-byte row.  Rows past n or m and k past
  // the split are zero-filled from valid addresses.
  const int cr = tid >> 3, cc = tid & 7;
  const __nv_bfloat16* a_src[4];
  const __nv_bfloat16* b_src[4];
  bool a_ok[4], b_ok[4];
  uint32_t soff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = cr + 32 * j;
    a_ok[j] = row0 + r < n;
    b_ok[j] = col0 + r < m;
    a_src[j] = a + (int64_t)(a_ok[j] ? row0 + r : 0) * kdim + kbeg + cc * 8;
    b_src[j] = wt + (int64_t)(b_ok[j] ? col0 + r : 0) * kdim + kbeg + cc * 8;
    soff[j] = r * 128 + ((cc ^ (r & 7)) << 4);
  }
  auto load = [&](int kt, int st) {
    const bool k_ok = kbeg + kt * BK + cc * 8 < kend;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ia = a_ok[j] && k_ok, ib = b_ok[j] && k_ok;
      cp_async16(sA + st * TILE + soff[j], ia ? a_src[j] + kt * BK : a, ia);
      cp_async16(sB + st * TILE + soff[j], ib ? b_src[j] + kt * BK : wt, ib);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();             // the copies are visible to wgmma
    __syncthreads();                 // tile kt landed; tile kt-1 consumed
    if (kt + STAGES - 1 < ntiles)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const int st = kt % STAGES;
    const uint64_t da = sw128_desc(sA + st * TILE + wg * 64 * 128);
    const uint64_t db = sw128_desc(sB + st * TILE);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma_m64n128k16(acc, da + 2 * j, db + 2 * j);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the epilogue

  // accumulator element 4 t + e (t = 0..15): row 16 wr + g (+8 for e >=
  // 2) of the warpgroup's 64, column 8 t + 2 tig + (e & 1)
  const int rbase = wg * 64 + wr * 16 + g;
  if (ws != nullptr) {               // split-K: f32 partials
    float* part = ws + (int64_t)blockIdx.z * n * m;
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int gr = row0 + rbase + hr * 8;
        const int gc = col0 + t * 8 + 2 * tig;
        if (gr < n && gc < m)
          *reinterpret_cast<float2*>(part + (int64_t)gr * m + gc) =
              make_float2(acc[4 * t + 2 * hr], acc[4 * t + 2 * hr + 1]);
      }
    return;
  }
  constexpr int LDC = BN + 8;        // staged C row, bf16
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(sA);
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(sC + (rbase + hr * 8) * LDC + t * 8 +
                                   2 * tig) =
          pack_bf16x2(acc[4 * t + 2 * hr], acc[4 * t + 2 * hr + 1]);
  __syncthreads();
  for (int i = tid; i < BM * (BN / 8); i += kThreads) {
    const int r = i / (BN / 8), q = i % (BN / 8);
    const int gr = row0 + r, gc = col0 + q * 8;
    if (gr < n && gc < m)
      *reinterpret_cast<uint4*>(c + (int64_t)gr * m + gc) =
          *reinterpret_cast<const uint4*>(sC + r * LDC + q * 8);
  }
}

// c[i] = round_bf16(sum over splits s, in order, of ws[s][i]); 4 per thread.
__global__ void __launch_bounds__(256)
splitk_sum_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ c,
                  int64_t nm, int splits) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= nm) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 t = *reinterpret_cast<const float4*>(ws + sp * nm + i);
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
    s.w += t.w;
  }
  *reinterpret_cast<uint2*>(c + i) =
      make_uint2(pack_bf16x2(s.x, s.y), pack_bf16x2(s.z, s.w));
}

// Splits of the k range for a (k, m) call: enough blocks for the card
// where the column tiles are few and k is long (never a function of n).
int gemm_splits(int kdim, int m) {
  const int col_tiles = (m + BN - 1) / BN;
  const int by_k = kdim / 1024, by_m = 32 / col_tiles;
  const int s = by_k < by_m ? by_k : by_m;
  return s < 1 ? 1 : s;
}

// Scratch of a (n, kdim, m) call: the bf16 transposed weight, then
// (split-K) the f32 partials, each 256-byte aligned.
int64_t align256(int64_t b) { return (b + 255) / 256 * 256; }

int64_t scratch_bytes(int64_t n, int kdim, int m) {
  const int splits = gemm_splits(kdim, m);
  return align256((int64_t)kdim * m * 2) +
         (splits > 1 ? (int64_t)splits * n * m * 4 : 0);
}

int launch(const void* a, const float* w, void* c, void* scratch, int64_t n,
           int kdim, int m, cudaStream_t s) {
  if ((n + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  static bool attrs_set = false;     // once per process
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        codec_gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(codec_gemm_wgmma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attrs_set = true;
  }
  const int splits = gemm_splits(kdim, m);
  __nv_bfloat16* wt = (__nv_bfloat16*)scratch;
  float* ws = (float*)((char*)scratch + align256((int64_t)kdim * m * 2));
  round_wt_kernel<<<dim3((unsigned)((m + 63) / 64),
                         (unsigned)((kdim + 63) / 64)),
                    256, 0, s>>>(w, wt, kdim, m);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int kps = ((kdim + splits - 1) / splits + BK - 1) / BK * BK;
  dim3 grid((unsigned)((m + BN - 1) / BN), (unsigned)((n + BM - 1) / BM),
            (unsigned)splits);
  codec_gemm_wgmma_kernel<<<grid, kThreads, SMEM, s>>>(
      (const __nv_bfloat16*)a, wt, (__nv_bfloat16*)c,
      splits > 1 ? ws : nullptr, (int)n, kdim, m, kps);
  rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  const int64_t nm = n * (int64_t)m;
  splitk_sum_kernel<<<(unsigned)((nm / 4 + 255) / 256), 256, 0, s>>>(
      ws, (__nv_bfloat16*)c, nm, splits);
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace rowpass {

// The vector layout the row kernels take (the wrappers check the same
// rule and raise first): widths a multiple of 8 elements and at most
// 32768, a pool of k in {1, 2, 4, 8}, qb a multiple of 8 dividing the
// pooled width when blocks are asked for.
bool bad_shape(int width, int k, int qb) {
  return width <= 0 || width % 8 != 0 || width > 32768 ||
         !(k == 1 || k == 2 || k == 4 || k == 8) ||
         (qb > 0 && (qb % 8 != 0 || (width / k) % qb != 0));
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

// CTA of a plan: one row, or several rows of one warp each.
int cta_threads(const Plan& p) {
  const int rpc = p.tpr >= kCtaThreads ? 1 : kCtaThreads / p.tpr;
  return rpc * p.tpr;
}

template <typename T>
int launch_ln(const void* x, void* out, int8_t* codes, float* scales,
              int64_t rows, int width, int k, int qb, cudaStream_t s) {
  Plan p;
  if (!plan_for(width / 8, 8, qb > 0, &p)) return (int)cudaErrorInvalidValue;
  const int cta = cta_threads(p);
  const int64_t grid = (rows + cta / p.tpr - 1) / (cta / p.tpr);
  const int L = qb > 0 ? qb * k / 8 : 1;
  const bool by_lanes = L <= 32 && (L & (L - 1)) == 0;
  const size_t smem = by_lanes ? 0 : sizeof(float) * cta * p.nu;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const T* xt = (const T*)x;
  T* ot = (T*)out;
#define REPRO_LN_ROWS(NU, K)                                               \
  ln_rows_kernel<T, NU, K><<<(unsigned)grid, cta, smem, s>>>(              \
      xt, ot, codes, scales, rows, width, qb, p.tpr)
#define REPRO_LN_ROWS_K(NU)                                                \
  switch (k_tpl) {                                                         \
    case 0: REPRO_LN_ROWS(NU, 0); break;                                   \
    case 1: REPRO_LN_ROWS(NU, 1); break;                                   \
    case 2: REPRO_LN_ROWS(NU, 2); break;                                   \
    case 4: REPRO_LN_ROWS(NU, 4); break;                                   \
    default: REPRO_LN_ROWS(NU, 8);                                         \
  }
  const int k_tpl = k == 1 && qb <= 0 ? 0 : k;   // 0: the LN alone
  switch (p.nu) {
    case 1: REPRO_LN_ROWS_K(1); break;
    case 2: REPRO_LN_ROWS_K(2); break;
    case 4: REPRO_LN_ROWS_K(4); break;
    case 8: REPRO_LN_ROWS_K(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_LN_ROWS_K
#undef REPRO_LN_ROWS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dequant(const int8_t* codes, const float* scales, void* out,
                   int64_t rows, int width, int qb, int ln,
                   cudaStream_t s) {
  const int U = width % 16 == 0 ? 16 : 8;
  Plan p;
  if (!plan_for(width / U, U, false, &p))
    return (int)cudaErrorInvalidValue;
  const int cta = cta_threads(p);
  const int64_t grid = (rows + cta / p.tpr - 1) / (cta / p.tpr);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  T* ot = (T*)out;
#define REPRO_DEQUANT_ROWS(NU, U)                                          \
  dequant_rows_kernel<T, NU, U><<<(unsigned)grid, cta, 0, s>>>(            \
      codes, scales, ot, rows, width, qb, ln, p.tpr)
  if (U == 16) {
    switch (p.nu) {
      case 1: REPRO_DEQUANT_ROWS(1, 16); break;
      case 2: REPRO_DEQUANT_ROWS(2, 16); break;
      case 4: REPRO_DEQUANT_ROWS(4, 16); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (p.nu) {
      case 1: REPRO_DEQUANT_ROWS(1, 8); break;
      case 2: REPRO_DEQUANT_ROWS(2, 8); break;
      case 4: REPRO_DEQUANT_ROWS(4, 8); break;
      case 8: REPRO_DEQUANT_ROWS(8, 8); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef REPRO_DEQUANT_ROWS
  return (int)cudaGetLastError();
}

}  // namespace rowpass

}  // namespace

// Row pass: out[r] = QDQ_qb(pool_k(round_T(LN(x[r])))) for every row;
// k = 1 skips the pool, qb = 0 skips the QDQ.  x and out 16-byte
// aligned, row-major and contiguous; the shape rule of rowpass::bad_shape.
extern "C" int repro_codec_ln_rows(const void* x, void* out, int64_t rows,
                                   int width, int k, int qb, int dtype,
                                   void* stream) {
  if (rowpass::bad_shape(width, k, qb) || rowpass::misaligned(x) ||
      rowpass::misaligned(out))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return rowpass::launch_ln<float>(x, out, nullptr, nullptr, rows, width,
                                     k, qb, s);
  if (dtype == DTYPE_BF16)
    return rowpass::launch_ln<__nv_bfloat16>(x, out, nullptr, nullptr,
                                             rows, width, k, qb, s);
  return (int)cudaErrorInvalidValue;
}

// Last row pass of encode_quantize: for every row, codes[r] (int8,
// width / k) and scales[r] (f32, width / k / qb) of the blocks of qb of
// pool_k(round_T(LN(x[r]))).  qb > 0; x and codes 16-byte aligned.
extern "C" int repro_codec_ln_rows_codes(const void* x, void* codes,
                                         void* scales, int64_t rows,
                                         int width, int k, int qb,
                                         int dtype, void* stream) {
  if (qb <= 0 || rowpass::bad_shape(width, k, qb) ||
      rowpass::misaligned(x) || rowpass::misaligned(codes) ||
      (uintptr_t)scales % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return rowpass::launch_ln<float>(x, nullptr, (int8_t*)codes,
                                     (float*)scales, rows, width, k, qb, s);
  if (dtype == DTYPE_BF16)
    return rowpass::launch_ln<__nv_bfloat16>(x, nullptr, (int8_t*)codes,
                                             (float*)scales, rows, width, k,
                                             qb, s);
  return (int)cudaErrorInvalidValue;
}

// First pass of dequantize_decode: out[r] = round_T(codes[r] * scales[r]
// / 127) (scales per block of qb), then round_T(LN(.)) when ln != 0; out
// is T [rows, width].  codes and out 16-byte aligned, qb > 0, the shape
// rule of rowpass::bad_shape (k = 1).
extern "C" int repro_codec_dequant_rows(const void* codes, const void* scales,
                                        void* out, int64_t rows, int width,
                                        int qb, int ln, int dtype,
                                        void* stream) {
  if (qb <= 0 || rowpass::bad_shape(width, 1, qb) ||
      rowpass::misaligned(codes) || rowpass::misaligned(out) ||
      (uintptr_t)scales % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return rowpass::launch_dequant<float>((const int8_t*)codes,
                                          (const float*)scales, out, rows,
                                          width, qb, ln, s);
  if (dtype == DTYPE_BF16)
    return rowpass::launch_dequant<__nv_bfloat16>((const int8_t*)codes,
                                                  (const float*)scales, out,
                                                  rows, width, qb, ln, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of device scratch repro_codec_gemm needs at (n, kdim, m): the
// weight rounded to bf16 and, where the kernel splits k, f32 partials.
extern "C" int64_t repro_codec_gemm_scratch(int64_t n, int kdim, int m,
                                           int dtype) {
  return dtype == DTYPE_BF16 ? tc::scratch_bytes(n, kdim, m) : 0;
}

// c[n, m] = a[n, kdim] (T) x round_T(w[kdim, m]) (f32), f32 accumulation,
// c rounded to T.  Row-major, contiguous.  bf16 runs on the tensor cores
// (kdim and m multiples of 8, a and w 16-byte aligned, `scratch` of
// repro_codec_gemm_scratch bytes, 256-byte aligned), f32 on the SIMT
// kernel (`scratch` unused).
extern "C" int repro_codec_gemm(const void* a, const float* w, void* c,
                                void* scratch, int64_t n, int kdim, int m,
                                int dtype, void* stream) {
  if (kdim <= 0 || m <= 0 || n > (int64_t)65535 * BM)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16) {
    if (kdim % 8 != 0 || m % 8 != 0 || scratch == nullptr ||
        ((uintptr_t)a | (uintptr_t)w) % 16 != 0 || (uintptr_t)scratch % 256)
      return (int)cudaErrorInvalidValue;
    return tc::launch(a, w, c, scratch, n, kdim, m, s);
  }
  if (dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((m + BN - 1) / BN), (unsigned)((n + BM - 1) / BM));
  gemm_kernel<float><<<grid, kGemmThreads, 0, s>>>(
      (const float*)a, w, (float*)c, (int)n, kdim, m);
  return (int)cudaGetLastError();
}
