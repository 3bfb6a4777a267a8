// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its tensors as raw device pointers plus a dtype code
// (DTYPE_F32 / DTYPE_BF16, see repro_torch/kernels/_lib.py), launches on
// the stream it is handed, and its C entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DTYPE_F32 0
#define DTYPE_BF16 1

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as XLA casts
}

// Sum / max over a full warp with butterfly shuffles.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- tensor-core building blocks (sm_80+ PTX, used on sm_90a) ----------
// 16-byte asynchronous copy global -> shared; with `full` false nothing is
// read and the 16 bytes are zero-filled (`src` must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* smem, const void* src,
                                           bool full) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register j receives matrix j (rows lane / 4, elements
// 2 (lane % 4) and 2 (lane % 4) + 1; with .trans the transpose).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16 bf16, row) x b (16x8 bf16, col), f32 accumulators.
// Fragments, with g = lane / 4 and t = lane % 4: a0 (row g, k 2t..2t+1),
// a1 (row g+8, same k), a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..);
// b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g); d0,d1 (row g, cols
// 2t, 2t+1), d2,d3 (row g+8, same cols).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (RNE, as __float2bfloat16_rn), `lo` in the
// low half: the lower k index of a fragment, the lower address in memory.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- Hopper warpgroup MMA (sm_90a) -----------------------------------
// d (64 rows x 128 columns of f32: the warpgroup's m64n128 accumulator,
// laid out as 16 mma.m16n8 tiles per warp, warps stacked by 16 rows) +=
// A (64 x 16 bf16, K-major, descriptor da) x B (16 x 128, K-major, db).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy writes to shared memory (cp.async
// included, once waited for) visible to the async proxy that wgmma reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major bf16 tile with 128-byte swizzle: rows of 64
// elements (128 bytes), 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), 8-row groups 1024 bytes apart, tile 1024-byte aligned.
// Adding 2 steps the start 32 bytes, i.e. 16 elements along k.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ---- 16-byte vector access (the codec's row passes, qdq) ---------------
// Element loads go through the read-only path (LDG.E.128); pointers are
// 16-byte aligned where a 16-byte access is made, which the wrappers
// check.  bf16 <-> f32 is exact one way and RNE the other
// (`pack_bf16x2`, as `__float2bfloat16_rn`).
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& lo,
                                              float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// v[0, N) = the N elements at p, in 16-byte loads (N a multiple of 8).
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  static_assert(N % 8 == 0, "16-byte loads of bf16");
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + c);
    unpack_bf16x2(w.x, v[8 * c + 0], v[8 * c + 1]);
    unpack_bf16x2(w.y, v[8 * c + 2], v[8 * c + 3]);
    unpack_bf16x2(w.z, v[8 * c + 4], v[8 * c + 5]);
    unpack_bf16x2(w.w, v[8 * c + 6], v[8 * c + 7]);
  }
}

// f32 version: 16-byte loads of 4 (N a multiple of 4).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  static_assert(N % 4 == 0, "16-byte loads of f32");
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p) + c);
    v[4 * c + 0] = w.x;
    v[4 * c + 1] = w.y;
    v[4 * c + 2] = w.z;
    v[4 * c + 3] = w.w;
  }
}

// The N elements at p = v[0, N) rounded to bf16, in one store of 2 N bytes
// (N <= 8) or 16-byte stores; p aligned to the store's size.
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else {
    static_assert(N % 8 == 0, "16-byte stores of bf16");
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
      reinterpret_cast<uint4*>(p)[c] = make_uint4(
          pack_bf16x2(v[8 * c + 0], v[8 * c + 1]),
          pack_bf16x2(v[8 * c + 2], v[8 * c + 3]),
          pack_bf16x2(v[8 * c + 4], v[8 * c + 5]),
          pack_bf16x2(v[8 * c + 6], v[8 * c + 7]));
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 1) {
    *p = v[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    static_assert(N % 4 == 0, "16-byte stores of f32");
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      reinterpret_cast<float4*>(p)[c] =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// v[0, N) = the N int8 codes at p as f32, in one 4-, 8- or 16-byte load
// (p aligned to N bytes).
template <int N>
__device__ __forceinline__ void load_codes(const int8_t* p, float* v) {
  static_assert(N == 4 || N == 8 || N == 16, "4- to 16-byte loads of codes");
  uint32_t w[N / 4];
  if constexpr (N == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (N == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    v[e] = (float)((int32_t)(w[e / 4] << (24 - 8 * (e % 4))) >> 24);
}

// The N int8 codes at p = q[0, N) (integral values in [-127, 127]), in
// one store of N bytes; p aligned to N bytes.
template <int N>
__device__ __forceinline__ void store_codes(int8_t* p, const float* q) {
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "1 to 8 codes");
  if constexpr (N == 1) {
    *p = (int8_t)q[0];
  } else {
    uint32_t w[(N + 3) / 4] = {};
#pragma unroll
    for (int e = 0; e < N; ++e)
      w[e / 4] |= ((uint32_t)(int32_t)q[e] & 0xffu) << (8 * (e % 4));
    if constexpr (N == 2)
      *reinterpret_cast<uint16_t*>(p) = (uint16_t)w[0];
    else if constexpr (N == 4)
      *reinterpret_cast<uint32_t*>(p) = w[0];
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// Per-block int8 code of v in a block of absmax s: clip(rint(v /
// max(s, 1e-12) * 127), -127, 127), the division IEEE (no fast math).
__device__ __forceinline__ float int8_code(float v, float s) {
  const float q = rintf(__fdiv_rn(v, fmaxf(s, 1e-12f)) * 127.0f);
  return fminf(fmaxf(q, -127.0f), 127.0f);
}

// The IEEE fallbacks of the two helpers below, out of line: they are
// rare, and inlined they made the kernels' code several times larger
// (which a cold call fetches from device memory).
static __device__ __noinline__ float int8_code_ieee(float v, float s) {
  return int8_code(v, s);
}

static __device__ __noinline__ float div127_ieee(float p) {
  return __fdiv_rn(p, 127.0f);
}

// q[e] = int8_code(v[e], s) for N values of one block of absmax s, with
// one IEEE division for the block: c = 127 / max(s, 1e-12), and v c lies
// within 4 u 127 < 3.1e-5 (u = 2^-24) of RN(RN(v / max(s, 1e-12)) 127),
// as |v| <= s, so its rint is the same code unless v c is within 2^-12
// of a half-integer; where one is, the IEEE division decides the codes.
template <int N>
__device__ __forceinline__ void block_codes(const float* v, float s,
                                            float* q) {
  const float c = __fdiv_rn(127.0f, fmaxf(s, 1e-12f));
  bool near_tie = false;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float t = __fmul_rn(v[e], c);
    q[e] = rintf(t);
    near_tie |= fabsf(t - q[e]) > 0.5f - 0x1p-12f;
    q[e] = fminf(fmaxf(q[e], -127.0f), 127.0f);
  }
  if (near_tie) {
#pragma unroll
    for (int e = 0; e < N; ++e) q[e] = int8_code_ieee(v[e], s);
  }
}

// y[e] = RN(RN(q[e] s) / 127), bit-equal to __fdiv_rn(q s, 127.0f), for N
// codes of one block: y0 = RN(p R) with R = RN(1/127) (relative error
// 2^-28, so y0 is within one ulp), then one Markstein correction with the
// exact remainder p - 127 y0.  Equal to the IEEE quotient over whole
// binades (tests/test_torch_kernels.py) wherever p, y0 and the remainder
// are normal, which holds for every code when s is 0 or in [2^-93, 2^93]
// (|q s| is 0 or in [2^-93, 2^100]); zeros keep their sign.  Other
// scales take the IEEE division.
template <int N>
__device__ __forceinline__ void block_dequant(const float* q, float s,
                                              float* y) {
  if (s == 0.f || (s >= 0x1p-93f && s <= 0x1p93f)) {
    constexpr float R = 0x1.020408p-7f;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float p = __fmul_rn(q[e], s);
      const float y0 = __fmul_rn(p, R);
      y[e] = copysignf(fmaf(fmaf(-y0, 127.0f, p), R, y0), p);
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) y[e] = div127_ieee(__fmul_rn(q[e], s));
  }
}

// Max over aligned groups of `lanes` lanes (a power of two <= 32; every
// lane of the warp calls it); every lane of a group gets its max.
__device__ __forceinline__ float group_max(float v, int lanes) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    if (o < lanes) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
