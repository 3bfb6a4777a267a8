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
// Design: the kernels of blockq.cuh with the round trip's values as
// output (codes and scales too where the caller asks: the comparison
// harness reads them; the wire path passes null).  The whole blocks take
// the path the wrapper chose (`flat_block_path`); the wire's blocks of 64
// take the lane-group kernel, one 16-byte vector a thread, one IEEE
// division a block.  A partial tail block (zeros past n count for its
// absmax, nothing is stored past n) takes the scalar group kernel in a
// second launch; on the scalar path one launch takes all blocks.
#include "blockq.cuh"

namespace {

template <typename T, bool CODES>
int launch_as(const T* x, T* out, int8_t* codes, float* scales, int64_t n,
              int block, int path, cudaStream_t s) {
  const int64_t n_blocks = (n + block - 1) / block;
  if (path == BLOCKQ_SCALAR)
    return blockq::quantize<T, CODES, true>(x, out, codes, scales, n,
                                            n_blocks, block, path, s);
  const int64_t whole = n / block;
  int rc = blockq::quantize<T, CODES, true>(x, out, codes, scales,
                                            whole * block, whole, block,
                                            path, s);
  if (rc != 0 || whole == n_blocks) return rc;
  const int64_t e0 = whole * block;
  return blockq::quantize<T, CODES, true>(
      x + e0, out + e0, CODES ? codes + e0 : nullptr,
      CODES ? scales + whole : nullptr, n - e0, 1, block, BLOCKQ_SCALAR, s);
}

template <typename T>
int launch(const T* x, T* out, int8_t* codes, float* scales, int64_t n,
           int block, int path, cudaStream_t s) {
  return codes != nullptr
             ? launch_as<T, true>(x, out, codes, scales, n, block, path, s)
             : launch_as<T, false>(x, out, nullptr, nullptr, n, block, path,
                                   s);
}

}  // namespace

// x, out [n] in dtype; codes int8 [n] and scales f32 [ceil(n / block)],
// both given or both null; any block >= 1; `path` from the wrapper's
// `flat_block_path` (the lane and unit paths need 16-byte-aligned x, out
// and codes, which they check).
extern "C" int repro_qdq_flat(const void* x, void* out, void* codes,
                              void* scales, int64_t n, int block, int dtype,
                              int path, void* stream) {
  if (block <= 0 || n < 0 || (codes == nullptr) != (scales == nullptr) ||
      (uintptr_t)scales % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int8_t* c = (int8_t*)codes;
  float* sc = (float*)scales;
  if (dtype == DTYPE_F32)
    return launch<float>((const float*)x, (float*)out, c, sc, n, block,
                         path, s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>((const __nv_bfloat16*)x,
                                 (__nv_bfloat16*)out, c, sc, n, block, path,
                                 s);
  return (int)cudaErrorInvalidValue;
}
