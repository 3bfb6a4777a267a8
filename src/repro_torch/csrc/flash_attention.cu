// FlashAttention-2 forward (online softmax), optional log-sum-exp output.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// `flash_attention_fwd` (bodies `_flash_fwd_kernel` and, with an lse
// output, `_flash_fwd_kernel_lse`).  q [B,Sq,H,Dqk], k [B,Sk,KV,Dqk],
// v [B,Sk,KV,Dv] with GQA (query head h reads kv head h / (H/KV)); masks:
// causal, sliding window, and kpos < Sk; the query offset is fixed at
// Sk - Sq.  Scores q.k have the inputs' operands and f32 accumulation,
// times `scale` (the caller's: MLA passes Dqk^-0.5 of its concatenated
// nope + rope dims), in f32; P is rounded to v's dtype for the PV
// product, which accumulates in f32; the row sum adds the unrounded f32
// p; the output is [B,Sq,H,Dv] in v's dtype, lse = m + log(max(l,
// 1e-30)) in f32 laid out [B, KV, G, Sq] (== [B, H, Sq]).
//
// Head dims: the pairs (Dqk, Dv) of the models served, (64, 64),
// (120, 120) (h2o-danube-3), (128, 128), (192, 128) (DeepSeek-V2's MLA
// prefill: 128 nope + 64 rope dims against 128-dim values) and
// (256, 256) (gemma); each is one template instantiation of both kernels.
//
// Bound on the H100: operations at prefill shapes (2*Sq*Sk*(Dqk+Dv) flops
// per head against 2*(Sq*(Dqk+Dv) + Sk*(Dqk+Dv)) bytes: far above the
// 295 flop/byte balance point at S=512), bytes for short sequences; at
// S=512 a call is small enough that latency and occupancy decide.
//
// bf16 (every model path): `flash_fwd_mma_kernel<Dqk, Dv>`, on the tensor
// cores.  One 128-thread block per (query tile of 64 rows, batch*head);
// each of its 4 warps owns 16 query rows.  Q, K and V stay bf16 in shared
// memory, rows padded by 16 bytes so that `ldmatrix` reads 8 rows in 8
// distinct bank groups.  A head dim that is not a multiple of the mma
// k-step of 16 (120) is widened to the next one in shared memory: the
// copy zero-fills the pad columns of Q, K and V, so they add exact zeros
// to QK^T and to the pad columns of O, which are never stored.  Copies
// are 16-byte `cp.async` (a row of 120 bf16 is 15 of them); K/V tiles sit
// in a ring of 2 stages, the copy of tile t+1 in flight while tile t is
// in the tensor cores.  Up to a padded Dqk of 128, Q is read once into
// registers as mma A fragments, borrowing the ring's second stage until
// then (70 KB of shared memory a block at D=128, three blocks an SM);
// wider Q (192, 256) stays in a shared-memory region of its own and is
// re-read with `ldmatrix` for each key tile, so the O accumulator
// (Dv/2 f32 registers a thread: 128 at Dv=256) has the registers; at
// Dv=256 key tiles are 32 keys, halving the score and P fragments (101 KB
// of shared memory a block; 112 KB at (192, 128)).  S = Q K^T is
// `mma.sync.m16n8k16` (bf16 operands, f32 accumulation; K fragments by
// `ldmatrix`); the online softmax runs in registers (row max and row sum
// across the 4 threads of a quad by shuffles, exp2 of log2(e)-prescaled
// scores); P is rounded to bf16 in registers and fed back as the A
// operand of PV (the m16n8k16 accumulator layout is the A fragment
// layout), V fragments by `ldmatrix.trans`.  Masks apply only on key
// tiles that straddle the causal or window edge or Sk.  Fixed key-tile
// order, no atomics, no split over keys: a row's result depends only on
// its own q row, k, v and the masks.  The output goes through shared
// memory to 16-byte stores.  The bf16 path needs 16-byte-aligned tensors
// with batch/seq/head strides that are multiples of 8 elements (the
// wrapper checks).  Query tiles run heaviest first (causal), which
// shortens the tail of the grid.
//
// f32: `flash_fwd_kernel<T, Dqk, Dv>`, the first SIMT design, kept
// because TF32 would break the f32 path's 1e-4 bound and no model path
// runs attention in f32: the query tile lives in shared memory as f32;
// the block walks key tiles of 64 rows, staging K and V as f32 in shared
// memory.  Thread t owns query row t/2 and one half of the key tile
// (scores, 32 registers) and one half of the value dim (output
// accumulator, Dv/2 registers); the two threads of a row combine their
// row max and row sum with one shuffle.  Q and K rows are padded by one
// float in shared memory so the 16 rows a warp touches fall in distinct
// banks.
//
// Both loop only over key tiles the causal/window masks leave open for
// some row of the tile (the TPU kernel runs every tile; a skipped tile
// adds exactly zero there, so the output is the same), and address the
// tensors through their batch/seq/head strides, so [B,S,H,D] views need
// no transpose copies; the last dim must be contiguous.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 128;
constexpr float NEG_INF = -1e30f;

template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (DQK + 1) + BK * (DQK + 1) + BK * DV + BQ * (BK + 1));
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                 int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                 int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                 int64_t vsh, float scale, int causal, int window) {
  static_assert(DV % 2 == 0, "the value dim splits in two halves");
  extern __shared__ float smem[];
  float* sQ = smem;                   // [BQ][DQK+1]
  float* sK = sQ + BQ * (DQK + 1);    // [BK][DQK+1]
  float* sV = sK + BK * (DQK + 1);    // [BK][DV]
  float* sP = sV + BK * DV;           // [BQ][BK+1]

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

  for (int i = tid; i < BQ * DQK; i += kThreads) {
    const int rr = i / DQK, dd = i % DQK;
    const int qi = q0 + rr;
    sQ[rr * (DQK + 1) + dd] = qi < Sq ? to_f32(qb[qi * qss + dd]) : 0.f;
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
  float acc[DV / 2];
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) acc[j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                  // previous tile fully consumed
    for (int i = tid; i < BK * DQK; i += kThreads) {
      const int rr = i / DQK, dd = i % DQK;
      const int ki = k0 + rr;
      sK[rr * (DQK + 1) + dd] = ki < Sk ? to_f32(kb[ki * kss + dd]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += kThreads) {
      const int rr = i / DV, dd = i % DV;
      const int ki = k0 + rr;
      sV[rr * DV + dd] = ki < Sk ? to_f32(vb[ki * vss + dd]) : 0.f;
    }
    __syncthreads();

    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
    const float* qrow = sQ + r * (DQK + 1);
    const float* kh = sK + half * (BK / 2) * (DQK + 1);
    for (int dd = 0; dd < DQK; ++dd) {
      const float qv = qrow[dd];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] += qv * kh[j * (DQK + 1) + dd];
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
    const float* vh = sV + half * (DV / 2);
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) acc[j] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
      const float* vr = vh + c * DV;
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) acc[j] += p * vr[j];
    }
  }

  const int qi = q0 + r;
  if (qi < Sq) {
    const float den = fmaxf(l, 1e-30f);
    T* o = out + (((int64_t)b * Sq + qi) * H + h) * DV + half * (DV / 2);
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) o[j] = from_f32<T>(acc[j] / den);
    if (lse != nullptr && half == 0)
      lse[((int64_t)b * H + h) * Sq + qi] = m + logf(den);
  }
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KV, int Sq, int Sk,
           const int64_t* st, float scale, int causal, int window,
           cudaStream_t s) {
  const size_t smem = smem_bytes<DQK, DV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, DQK, DV><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, KV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ bf16: tensor cores
namespace tc {

constexpr int BQ = 64;               // query rows per block (16 per warp)
constexpr int kThreads = 128;

// The shared-memory geometry of one (Dqk, Dv) instantiation.
template <int DQK, int DV>
struct Geom {
  static constexpr int DK = (DQK + 15) / 16 * 16;  // Q/K width, k-steps
  static constexpr int DVP = (DV + 15) / 16 * 16;  // V/O width, n-tiles
  static constexpr int LDK = DK + 8;               // rows padded 16 bytes
  static constexpr int LDV = DVP + 8;
  static constexpr int CK = DQK / 8, CKP = DK / 8;   // 16-byte chunks a row:
  static constexpr int CV = DV / 8, CVP = DVP / 8;   // real, and padded
  static constexpr bool QREG = DK <= 128;   // Q as register fragments
  static constexpr int BK = DVP > 128 ? 32 : 64;     // keys per tile
  static constexpr int STAGE = BK * (LDK + LDV);     // K then V rows
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (size_t)(2 * STAGE + (QREG ? 0 : BQ * LDK));
  static_assert(DQK % 8 == 0 && DV % 8 == 0, "16-byte rows");
  // Q borrows the ring's second stage (QREG) or has its own region; O is
  // staged through the same region at stride LDV
  static_assert(QREG ? BQ * LDK <= STAGE : LDV <= LDK, "Q region");
  static_assert(BQ * LDV <= (QREG ? STAGE : BQ * LDK), "O staging");
};

// 16-byte copies of rows [row0, row0 + ROWS) of `src` (row stride
// `stride` elements) into `dst` (row stride LD): CP chunks a row, of
// which the first C are real; rows at or past `rows` and the pad chunks
// are zero-filled (p * 0, never NaN) from a valid address.  Where CP
// divides the block, each thread keeps one column and steps over rows.
template <int ROWS, int CP, int C, int LD>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int row0, int rows,
                                          int tid) {
  static_assert(ROWS * CP % kThreads == 0, "whole copy rounds");
  if constexpr (kThreads % CP == 0) {
    constexpr int RS = kThreads / CP;      // rows a round
    const int r0 = tid / CP, cc = tid % CP;
#pragma unroll
    for (int j = 0; j < ROWS / RS; ++j) {
      const int r = r0 + j * RS;
      const bool in = cc < C && row0 + r < rows;
      cp_async16(dst + r * LD + cc * 8,
                 src + (in ? (row0 + r) * stride + cc * 8 : 0), in);
    }
  } else {
#pragma unroll
    for (int j = 0; j < ROWS * CP / kThreads; ++j) {
      const int c = tid + j * kThreads;
      const int r = c / CP, cc = c % CP;
      const bool in = cc < C && row0 + r < rows;
      cp_async16(dst + r * LD + cc * 8,
                 src + (in ? (row0 + r) * stride + cc * 8 : 0), in);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int H, int KV, int Sq, int Sk, int64_t qsb, int64_t qss,
                     int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                     int64_t vsb, int64_t vss, int64_t vsh, float scale_log2,
                     int causal, int window) {
  using G = Geom<DQK, DV>;
  constexpr int DK = G::DK, DVP = G::DVP, LDK = G::LDK, LDV = G::LDV;
  constexpr int BK = G::BK;
  constexpr bool QREG = G::QREG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: K rows [BK][LDK] at s * STAGE, then V rows [BK][LDV]
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sQ = ring + (QREG ? G::STAGE : 2 * G::STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int off = Sk - Sq;
  const int wr0 = warp * 16;         // the warp's first row in the tile

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;

  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, off + q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, off + q0 - window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  // K/V copy roles where Q, K and V rows are equally wide and unpadded
  // (64, 128): chunk j of this thread is key row tid/CP + j*RSTEP of the
  // tile, dim chunk tid%CP, the K chunk beside the V chunk; keys past Sk
  // are zero-filled (p * 0, never NaN) from a valid address.  Other
  // widths take copy_rows (pad columns, two widths).
  constexpr bool PLAIN = G::CK == G::CKP && G::CV == G::CVP &&
                         G::CK == G::CV && kThreads % G::CK == 0;
  constexpr int CP = G::CK, RSTEP = kThreads / CP;
  const int kv_r = tid / CP, kv_c = (tid % CP) * 8;
  if constexpr (PLAIN) {
    for (int c = tid; c < BQ * CP; c += kThreads) {
      const int r = c / CP, cc = c % CP;
      const int qi = q0 + r;
      const bool in = qi < Sq;
      cp_async16(sQ + r * LDK + cc * 8, qb + (in ? qi : 0) * qss + cc * 8,
                 in);
    }
  } else {
    copy_rows<BQ, G::CKP, G::CK, LDK>(sQ, qb, qss, q0, Sq, tid);
  }
  auto load_kv = [&](int t, int st) {
    __nv_bfloat16* dk = ring + st * G::STAGE;
    __nv_bfloat16* dv = dk + BK * LDK;
    if constexpr (PLAIN) {
      const int k0 = t * BK + kv_r;
      dk += kv_r * LDK + kv_c;
      dv += kv_r * LDV + kv_c;
#pragma unroll
      for (int j = 0; j < BK / RSTEP; ++j) {
        const int ki = k0 + j * RSTEP;
        const bool in = ki < Sk;
        const int kr = in ? ki : 0;
        cp_async16(dk + j * RSTEP * LDK, kb + kr * kss + kv_c, in);
        cp_async16(dv + j * RSTEP * LDV, vb + kr * vss + kv_c, in);
      }
    } else {
      copy_rows<BK, G::CKP, G::CK, LDK>(dk, kb, kss, t * BK, Sk, tid);
      copy_rows<BK, G::CVP, G::CV, LDV>(dv, vb, vss, t * BK, Sk, tid);
    }
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  uint32_t qf[QREG ? DK / 16 : 1][4];  // Q as A fragments (QREG)
  float o[DVP / 8][4];               // O: 16 rows x DVP per warp
#pragma unroll
  for (int n = 0; n < DVP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}; // rows g and g+8, log2 units
  float l_r[2] = {0.f, 0.f};         // this thread's share of the row sums

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();                 // tile t landed; tile t-1 consumed
    if constexpr (QREG) {
      if (t == t_begin) {
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          ldmatrix_x4(qf[kk], sQ + (wr0 + (lane & 15)) * LDK + kk * 16 +
                                  (lane >> 4) * 8);
        __syncthreads();             // every warp holds Q: stage 1 is free
      }
    }
    if (t + 1 < t_end) load_kv(t + 1, st ^ 1);
    cp_async_commit();
    const __nv_bfloat16* Ks = ring + st * G::STAGE;
    const __nv_bfloat16* Vs = Ks + BK * LDK;

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    auto qk = [&](const uint32_t (&qa)[4], int kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bf[4];              // n-tiles 2np (bf 0,1) and 2np+1 (2,3)
        ldmatrix_x4(bf, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDK
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * np], qa, bf[0], bf[1]);
        mma_bf16_16816(s[2 * np + 1], qa, bf[2], bf[3]);
      }
    };
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      if constexpr (QREG) {
        qk(qf[kk], kk);
      } else {
        uint32_t qa[4];
        ldmatrix_x4(qa, sQ + (wr0 + (lane & 15)) * LDK + kk * 16 +
                            (lane >> 4) * 8);
        qk(qa, kk);
      }
    }

    const int k0 = t * BK;
    const bool edge = k0 + BK > Sk ||
                      (causal && k0 + BK - 1 > off + q0) ||
                      (window > 0 && off + q0 + BQ - 1 - k0 >= window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
          const int qpos = off + q0 + wr0 + g + (e >> 1) * 8;
          bool ok = kpos < Sk;
          if (causal) ok = ok && (qpos >= kpos);
          if (window > 0) ok = ok && (qpos - kpos < window);
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
    uint32_t pf[BK / 16][4];         // P as A fragments of PV
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = exp2f(s[j][0] - mx[0]), p1 = exp2f(s[j][1] - mx[0]);
      const float p2 = exp2f(s[j][2] - mx[1]), p3 = exp2f(s[j][3] - mx[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16x2(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < DVP / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
#pragma unroll
      for (int dp = 0; dp < DVP / 16; ++dp) {
        uint32_t bf[4];              // dim n-tiles 2dp (bf 0,1), 2dp+1 (2,3)
        ldmatrix_x4_trans(bf, Vs + (c * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LDV +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16_16816(o[2 * dp], pf[c], bf[0], bf[1]);
        mma_bf16_16816(o[2 * dp + 1], pf[c], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();                // no copy may land in sQ below
  __syncthreads();                   // and no warp still reads Q or a tile

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = fmaxf(l, 1e-30f);
  }
  // the warp's own 16 rows of the Q region stage O, at stride LDV
  __nv_bfloat16* sO = sQ + wr0 * LDV;
#pragma unroll
  for (int n = 0; n < DVP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(sO + g * LDV + n * 8 + tig * 2) =
        pack_bf16x2(o[n][0] / den[0], o[n][1] / den[0]);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * LDV + n * 8 + tig * 2) =
        pack_bf16x2(o[n][2] / den[1], o[n][3] / den[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * G::CV; c += 32) {   // the DV real columns
    const int r = c / G::CV, cc = c % G::CV;
    const int qi = q0 + wr0 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + qi) * H + h) * DV
                                + cc * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LDV + cc * 8);
  }
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + wr0 + g + r * 8;
      if (qi < Sq)
        lse[((int64_t)b * H + h) * Sq + qi] =
            m_r[r] * 0.69314718055994531f + logf(den[r]);
    }
  }
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KV, int Sq, int Sk,
           const int64_t* st, float scale, int causal, int window,
           cudaStream_t s) {
  const size_t smem = Geom<DQK, DV>::SMEM;
  static bool attrs_set = false;     // once per process and instantiation
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<DQK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_mma_kernel<DQK, DV>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attrs_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_mma_kernel<DQK, DV><<<grid, kThreads, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, lse, H, KV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <int DQK, int DV>
int launch_pair(int dtype, const void* q, const void* k, const void* v,
                void* out, float* lse, int B, int H, int KV, int Sq, int Sk,
                const int64_t* st, float scale, int causal, int window,
                cudaStream_t s) {
  if (dtype == DTYPE_F32)
    return launch<float, DQK, DV>(q, k, v, out, lse, B, H, KV, Sq, Sk, st,
                                  scale, causal, window, s);
  if (dtype == DTYPE_BF16)
    return tc::launch<DQK, DV>(q, k, v, out, lse, B, H, KV, Sq, Sk, st,
                               scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: q (batch, seq, head), k (batch, seq, head), v (batch, seq, head)
// in elements; the head dim is contiguous.  f32 runs the SIMT kernel, bf16
// the tensor-core kernel, which also needs 16-byte-aligned q, k, v and
// strides that are multiples of 8.  out is a contiguous [B, Sq, H, Dv]
// tensor of q's dtype; lse (nullable) a contiguous f32 [B, H, Sq].
// (head_dim, head_dim_v) must be one of (64, 64), (120, 120), (128, 128),
// (192, 128), (256, 256).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int H, int KV,
                               int Sq, int Sk, int head_dim, int head_dim_v,
                               const int64_t* strides, float scale,
                               int causal, int window, int dtype,
                               void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
#define REPRO_FLASH_PAIR(DQK, DV)                                          \
  if (head_dim == DQK && head_dim_v == DV)                                 \
    return launch_pair<DQK, DV>(dtype, q, k, v, out, l, B, H, KV, Sq, Sk,  \
                                strides, scale, causal, window, s);
  REPRO_FLASH_PAIR(64, 64)
  REPRO_FLASH_PAIR(120, 120)
  REPRO_FLASH_PAIR(128, 128)
  REPRO_FLASH_PAIR(192, 128)
  REPRO_FLASH_PAIR(256, 256)
#undef REPRO_FLASH_PAIR
  return (int)cudaErrorInvalidValue;
}
