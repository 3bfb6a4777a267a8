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
//   q * s / 127 with IEEE divisions, as qdq.cu (no --use_fast_math).
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
//   ln_rows  — one 256-thread block per row: the row is staged in shared
//              memory as f32, LN, round to T, optional maxout pool,
//              optional row-blocked QDQ, write T.
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
//   dequant_rows — one 256-thread block per row: codes * scale / 127,
//              round to T, optional LN, write T.
// encode bottleneck = ln_rows(x) -> gemm(w_c) -> ln_rows(+QDQ);
// encode maxout     = ln_rows(x, pool k, +QDQ);
// decode bottleneck = gemm(w_d); decode maxout = ln_rows(z) -> gemm(w_d);
// encode_quantize   = the encode passes, the last ln_rows emitting codes;
// dequantize_decode = dequant_rows(+LN for maxout) -> gemm(w_d).
#include "common.cuh"

namespace {

constexpr int kRowThreads = 256;

// Sum over the block of one f64 value per thread (kRowThreads threads).
__device__ __forceinline__ double block_sum_f64(double v, double* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum_f64(v);
  __syncthreads();  // `part` may still be read from the previous call
  if (lane == 0) part[warp] = v;
  __syncthreads();
  double t = lane < kRowThreads / 32 ? part[lane] : 0.0;
  return warp_sum_f64(t);  // every warp holds the total
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// In place over a row staged in shared memory (every thread of the block
// calls it): row = round_T(LN(row)), the LN core in f32 with its two
// means summed in f64 and rounded once.
template <typename T>
__device__ void ln_row(float* row, int width, double* part) {
  double s = 0.0;
  for (int j = threadIdx.x; j < width; j += kRowThreads) s += (double)row[j];
  s = block_sum_f64(s, part);
  const float mu = (float)(s / (double)width);
  double ss = 0.0;
  for (int j = threadIdx.x; j < width; j += kRowThreads) {
    const float d = row[j] - mu;
    const float sq = d * d;          // f32 square, as (x - mu) ** 2
    ss += (double)sq;
  }
  ss = block_sum_f64(ss, part);
  const float var = (float)(ss / (double)width);
  const float rstd = rsqrtf(var + 1e-6f);
  for (int j = threadIdx.x; j < width; j += kRowThreads) {
    row[j] = round_to<T>((row[j] - mu) * rstd);
  }
  __syncthreads();
}

// Per-block absmax quantization of src[0, qb): code q = clip(rint(
// x / max(s, 1e-12) * 127), -127, 127) with an IEEE division.
__device__ __forceinline__ float block_absmax(const float* blk, int qb) {
  float amax = 0.f;
  for (int i = 0; i < qb; ++i) amax = fmaxf(amax, fabsf(blk[i]));
  return amax;
}

__device__ __forceinline__ float code_of(float v, float amax) {
  const float q = rintf(__fdiv_rn(v, fmaxf(amax, 1e-12f)) * 127.0f);
  return fminf(fmaxf(q, -127.0f), 127.0f);
}

// Row pass of the encode: LN -> round to T -> optional maxout pool of k ->
// either T output (optionally QDQ'd in blocks of qb) or, with `codes`
// non-null, int8 codes and f32 block scales of blocks of qb.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_rows_kernel(const T* __restrict__ x, T* __restrict__ out,
               int8_t* __restrict__ codes, float* __restrict__ scales,
               int width, int k, int qb) {
  extern __shared__ float smem[];
  float* row = smem;                 // [width]
  float* pooled = smem + width;      // [width / k], only when k > 1
  __shared__ double part[kRowThreads / 32];
  const int64_t r = blockIdx.x;
  const T* xr = x + r * width;
  const int wout = width / k;

  for (int j = threadIdx.x; j < width; j += kRowThreads)
    row[j] = to_f32(xr[j]);
  __syncthreads();
  ln_row<T>(row, width, part);
  const float* src = row;
  if (k > 1) {
    for (int j = threadIdx.x; j < wout; j += kRowThreads) {
      float m = row[j * k];
      for (int i = 1; i < k; ++i) m = fmaxf(m, row[j * k + i]);
      pooled[j] = m;
    }
    __syncthreads();
    src = pooled;
  }
  if (codes != nullptr) {
    // true wire format: one thread per block of qb elements
    const int nblk = wout / qb;
    int8_t* crow = codes + r * (int64_t)wout;
    for (int b = threadIdx.x; b < nblk; b += kRowThreads) {
      const float* blk = src + b * qb;
      const float amax = block_absmax(blk, qb);
      for (int i = 0; i < qb; ++i)
        crow[b * qb + i] = (int8_t)code_of(blk[i], amax);
      scales[r * nblk + b] = amax;
    }
    return;
  }
  T* orow = out + r * (int64_t)wout;
  if (qb <= 0) {
    for (int j = threadIdx.x; j < wout; j += kRowThreads)
      orow[j] = from_f32<T>(src[j]);
    return;
  }
  // row-blocked QDQ: one thread per block of qb elements
  const int nblk = wout / qb;
  for (int b = threadIdx.x; b < nblk; b += kRowThreads) {
    const float* blk = src + b * qb;
    const float amax = block_absmax(blk, qb);
    for (int i = 0; i < qb; ++i)
      orow[b * qb + i] =
          from_f32<T>(__fdiv_rn(code_of(blk[i], amax) * amax, 127.0f));
  }
}

// Row pass of dequantize_decode: z = round_T(q * s / 127) (f32, IEEE
// division), then round_T(LN(z)) when `ln`, written as T.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
dequant_rows_kernel(const int8_t* __restrict__ codes,
                    const float* __restrict__ scales, T* __restrict__ out,
                    int width, int qb, int ln) {
  extern __shared__ float smem[];
  float* row = smem;                 // [width]
  __shared__ double part[kRowThreads / 32];
  const int64_t r = blockIdx.x;
  const int8_t* crow = codes + r * width;
  const float* srow = scales + r * (int64_t)(width / qb);
  for (int j = threadIdx.x; j < width; j += kRowThreads)
    row[j] = round_to<T>(
        __fdiv_rn((float)crow[j] * srow[j / qb], 127.0f));
  __syncthreads();
  if (ln) ln_row<T>(row, width, part);
  T* orow = out + r * (int64_t)width;
  for (int j = threadIdx.x; j < width; j += kRowThreads)
    orow[j] = from_f32<T>(row[j]);
}

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

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_ln_rows(const void* x, void* out, int8_t* codes, float* scales,
                   int64_t rows, int width, int k, int qb, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (size_t)(width + (k > 1 ? width / k : 0));
  int e = allow_smem(ln_rows_kernel<T>, smem);
  if (e != 0) return e;
  ln_rows_kernel<T><<<(unsigned)rows, kRowThreads, smem, s>>>(
      (const T*)x, (T*)out, codes, scales, width, k, qb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dequant_rows(const int8_t* codes, const float* scales, void* out,
                        int64_t rows, int width, int qb, int ln,
                        cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)width;
  int e = allow_smem(dequant_rows_kernel<T>, smem);
  if (e != 0) return e;
  dequant_rows_kernel<T><<<(unsigned)rows, kRowThreads, smem, s>>>(
      codes, scales, (T*)out, width, qb, ln);
  return (int)cudaGetLastError();
}

bool bad_row_shape(int width, int k, int qb) {
  return width <= 0 || k <= 0 || width % k != 0 ||
         (qb > 0 && (width / k) % qb != 0);
}

}  // namespace

// Row pass: out[r] = QDQ_qb(pool_k(round_T(LN(x[r])))) for every row;
// k = 1 skips the pool, qb = 0 skips the QDQ.  width % k == 0 and
// (width / k) % qb == 0; the row and its pooled copy must fit in shared
// memory (width * (1 + 1/k) * 4 bytes, at most 227 KB).
extern "C" int repro_codec_ln_rows(const void* x, void* out, int64_t rows,
                                   int width, int k, int qb, int dtype,
                                   void* stream) {
  if (bad_row_shape(width, k, qb)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_ln_rows<float>(x, out, nullptr, nullptr, rows, width, k,
                                 qb, s);
  if (dtype == DTYPE_BF16)
    return launch_ln_rows<__nv_bfloat16>(x, out, nullptr, nullptr, rows,
                                         width, k, qb, s);
  return (int)cudaErrorInvalidValue;
}

// Last row pass of encode_quantize: for every row, codes[r] (int8,
// width / k) and scales[r] (f32, width / k / qb) of the blocks of qb of
// pool_k(round_T(LN(x[r]))).  qb > 0, (width / k) % qb == 0.
extern "C" int repro_codec_ln_rows_codes(const void* x, void* codes,
                                         void* scales, int64_t rows,
                                         int width, int k, int qb,
                                         int dtype, void* stream) {
  if (qb <= 0 || bad_row_shape(width, k, qb))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_ln_rows<float>(x, nullptr, (int8_t*)codes, (float*)scales,
                                 rows, width, k, qb, s);
  if (dtype == DTYPE_BF16)
    return launch_ln_rows<__nv_bfloat16>(x, nullptr, (int8_t*)codes,
                                         (float*)scales, rows, width, k, qb,
                                         s);
  return (int)cudaErrorInvalidValue;
}

// First pass of dequantize_decode: out[r] = round_T(codes[r] * scales[r]
// / 127) (scales per block of qb), then round_T(LN(.)) when ln != 0; out
// is T [rows, width].  width % qb == 0.
extern "C" int repro_codec_dequant_rows(const void* codes, const void* scales,
                                        void* out, int64_t rows, int width,
                                        int qb, int ln, int dtype,
                                        void* stream) {
  if (qb <= 0 || bad_row_shape(width, 1, qb))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_dequant_rows<float>((const int8_t*)codes,
                                      (const float*)scales, out, rows, width,
                                      qb, ln, s);
  if (dtype == DTYPE_BF16)
    return launch_dequant_rows<__nv_bfloat16>((const int8_t*)codes,
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
