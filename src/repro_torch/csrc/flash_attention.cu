// FlashAttention-2 forward (online softmax), optional log-sum-exp output.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// `flash_attention_fwd` (bodies `_flash_fwd_kernel` and, with an lse
// output, `_flash_fwd_kernel_lse`).  q [B,Sq,H,D], k/v [B,Sk,KV,D] with GQA
// (query head h reads kv head h / (H/KV)); masks: causal, sliding window,
// and kpos < Sk; the query offset is fixed at Sk - Sq.  Scores q.k are f32
// (q and k upcast), P is rounded to v's dtype for the PV product, the sum
// is f32, the output is v's dtype, lse = m + log(max(l, 1e-30)) in f32
// laid out [B, KV, G, Sq] (== [B, H, Sq]).  bf16 x bf16 products are exact
// in f32, so bf16 operands with f32 accumulation compute what the TPU
// kernel's f32 upcast computes, up to summation order.
//
// Bound on the H100: operations at prefill shapes (4*Sq*Sk*D flops per
// head against 2*(Sq+2*Sk)*D bytes: far above the 295 flop/byte balance
// point at S=512), bytes for short sequences.
//
// Design (simple first; tensor cores, TMA and wgmma are later work): one
// 128-thread block per (query tile of 64 rows, batch*head).  The query tile
// lives in shared memory as f32; the block walks key tiles of 64 rows,
// staging K and V as f32 in shared memory.  Thread t owns query row t/2 and
// one half of the key tile (scores, 32 registers) and one half of the head
// dim (output accumulator, D/2 registers); the two threads of a row combine
// their row max and row sum with one shuffle.  Rows are padded by one float
// in shared memory so the 16 rows a warp touches fall in distinct banks.
// The loop runs only over key tiles the causal/window masks leave open for
// some row of the tile (the TPU kernel runs every tile; a skipped tile adds
// exactly zero there, so the output is the same).  Tensors are addressed
// through their batch/seq/head strides, so [B,S,H,D] views need no
// transpose copies; the last dim must be contiguous.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 128;
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                 int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                 int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                 int64_t vsh, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* sQ = smem;                   // [BQ][D+1]
  float* sK = sQ + BQ * (D + 1);      // [BK][D+1]
  float* sV = sK + BK * (D + 1);      // [BK][D]
  float* sP = sV + BK * D;            // [BQ][BK+1]

  const int tid = threadIdx.x;
  const int r = tid >> 1;             // query row within the tile
  const int half = tid & 1;           // key half (scores) / dim half (acc)
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int off = Sk - Sq;            // query offset

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int qi = q0 + rr;
    sQ[rr * (D + 1) + dd] = qi < Sq ? to_f32(qb[qi * qss + dd]) : 0.f;
  }

  // key tiles some row of this query tile may attend to
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, off + q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, off + q0 - window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  const int qpos = off + q0 + r;
  float m = NEG_INF, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                  // previous tile fully consumed
    for (int i = tid; i < BK * D; i += kThreads) {
      const int rr = i / D, dd = i % D;
      const int ki = k0 + rr;
      const bool in = ki < Sk;
      sK[rr * (D + 1) + dd] = in ? to_f32(kb[ki * kss + dd]) : 0.f;
      sV[rr * D + dd] = in ? to_f32(vb[ki * vss + dd]) : 0.f;
    }
    __syncthreads();

    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
    const float* qrow = sQ + r * (D + 1);
    const float* kh = sK + half * (BK / 2) * (D + 1);
    for (int dd = 0; dd < D; ++dd) {
      const float qv = qrow[dd];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] += qv * kh[j * (D + 1) + dd];
    }

    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int kpos = k0 + half * (BK / 2) + j;
      bool ok = kpos < Sk;
      if (causal) ok = ok && (qpos >= kpos);
      if (window > 0) ok = ok && (qpos - kpos < window);
      s[j] = ok ? s[j] * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
    float* prow = sP + r * (BK + 1) + half * (BK / 2);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      prow[j] = round_to<T>(p);       // P in v's dtype for the PV product
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();                     // row partner's P half is visible

    const float* pr = sP + r * (BK + 1);
    const float* vh = sV + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
      const float* vr = vh + c * D;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] += p * vr[j];
    }
  }

  const int qi = q0 + r;
  if (qi < Sq) {
    const float den = fmaxf(l, 1e-30f);
    T* o = out + (((int64_t)b * Sq + qi) * H + h) * D + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = from_f32<T>(acc[j] / den);
    if (lse != nullptr && half == 0)
      lse[((int64_t)b * H + h) * Sq + qi] = m + logf(den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KV, int Sq, int Sk,
           const int64_t* st, float scale, int causal, int window,
           cudaStream_t s) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, KV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: q (batch, seq, head), k (batch, seq, head), v (batch, seq, head)
// in elements; the head dim is contiguous.  out is a contiguous
// [B, Sq, H, D] tensor of q's dtype; lse (nullable) a contiguous f32
// [B, H, Sq].  head_dim must be 64 or 128.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int H, int KV,
                               int Sq, int Sk, int head_dim,
                               const int64_t* strides, float scale,
                               int causal, int window, int dtype,
                               void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == DTYPE_F32 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, l, B, H, KV, Sq, Sk, strides,
                              scale, causal, window, s);
  if (dtype == DTYPE_F32 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, l, B, H, KV, Sq, Sk, strides,
                             scale, causal, window, s);
  if (dtype == DTYPE_BF16 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, l, B, H, KV, Sq, Sk,
                                      strides, scale, causal, window, s);
  if (dtype == DTYPE_BF16 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, l, B, H, KV, Sq, Sk,
                                     strides, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
