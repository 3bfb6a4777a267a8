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
// Design: blockq.cuh, on the path the wrapper chose
// (`flat_block_path`).  quantize is qdq's lane-group kernel without the
// values: a lane loads one 16-byte vector, a block is an aligned group of
// lanes (absmax by `group_max`), one IEEE division a block, the lane's
// codes in one 8- or 4-byte store and the scale from the group's first
// lane.  dequantize on the lane path takes min(16, block) codes a lane in
// one load, reads the block's scale once (the block is a power of two:
// a shift, no division) and writes 16-byte vectors.  Other blocks and
// unaligned views take the group kernels, a group of threads a block.
#include "blockq.cuh"

// x: flat [n_blocks * block] in dtype; codes int8 [n_blocks * block];
// scales f32 [n_blocks]; any block >= 1.
extern "C" int repro_quant8_quantize(const void* x, void* codes,
                                     void* scales, int64_t n_blocks,
                                     int block, int dtype, int path,
                                     void* stream) {
  if (block <= 0 || n_blocks < 0) return (int)cudaErrorInvalidValue;
  const int64_t n = n_blocks * block;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return blockq::quantize<float, true, false>(
        (const float*)x, nullptr, (int8_t*)codes, (float*)scales, n,
        n_blocks, block, path, s);
  if (dtype == DTYPE_BF16)
    return blockq::quantize<__nv_bfloat16, true, false>(
        (const __nv_bfloat16*)x, nullptr, (int8_t*)codes, (float*)scales, n,
        n_blocks, block, path, s);
  return (int)cudaErrorInvalidValue;
}

// codes int8 [n_blocks * block], scales f32 [n_blocks] -> out in dtype.
extern "C" int repro_quant8_dequantize(const void* codes, const void* scales,
                                       void* out, int64_t n_blocks,
                                       int block, int dtype, int path,
                                       void* stream) {
  if (block <= 0 || n_blocks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return blockq::dequantize<float>((const int8_t*)codes,
                                     (const float*)scales, (float*)out,
                                     n_blocks, block, path, s);
  if (dtype == DTYPE_BF16)
    return blockq::dequantize<__nv_bfloat16>(
        (const int8_t*)codes, (const float*)scales, (__nv_bfloat16*)out,
        n_blocks, block, path, s);
  return (int)cudaErrorInvalidValue;
}
