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
// for the LN / maxout / QDQ row passes.
//
// Design (simple first; tensor cores, TMA and wgmma are later work).  The
// second LN needs whole c-wide rows, which a GEMM tile does not hold
// (64 rows x 1024 f32 accumulators are 256 KB), so a call is up to three
// launches, each a plain kernel:
//   ln_rows  — one 256-thread block per row: the row is staged in shared
//              memory as f32, LN, round to T, optional maxout pool,
//              optional row-blocked QDQ, write T.
//   gemm     — C[n,m] = A[n,k] (T) x W[k,m] (f32 rounded to T on load),
//              64x64 output tiles, k-steps of 16 staged in shared memory
//              as f32, 4x4 outputs per thread in f32 FMA registers (bf16
//              products are exact in f32), C rounded to T.
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

// c[n, m] = a[n, kdim] (T) x round_T(w[kdim, m]) (f32), f32 accumulation,
// c rounded to T.  Row-major, contiguous.
extern "C" int repro_codec_gemm(const void* a, const float* w, void* c,
                                int64_t n, int kdim, int m, int dtype,
                                void* stream) {
  if (kdim <= 0 || m <= 0 || n > (int64_t)65535 * BM)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  dim3 grid((unsigned)((m + BN - 1) / BN), (unsigned)((n + BM - 1) / BM));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) {
    gemm_kernel<float><<<grid, kGemmThreads, 0, s>>>(
        (const float*)a, w, (float*)c, (int)n, kdim, m);
  } else if (dtype == DTYPE_BF16) {
    gemm_kernel<__nv_bfloat16><<<grid, kGemmThreads, 0, s>>>(
        (const __nv_bfloat16*)a, w, (__nv_bfloat16*)c, (int)n, kdim, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
