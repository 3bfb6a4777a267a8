from repro_torch.compression.quant8 import (
    blockwise_quantize, blockwise_dequantize, compress_boundary,
    quantization_error, compressed_nbytes,
)
from repro_torch.compression.bottleneck import bottleneck_specs, \
    apply_bottleneck
from repro_torch.compression.maxout import maxout_specs, apply_maxout
from repro_torch.compression import codecs

__all__ = [
    "blockwise_quantize", "blockwise_dequantize", "compress_boundary",
    "quantization_error", "compressed_nbytes", "bottleneck_specs",
    "apply_bottleneck", "maxout_specs", "apply_maxout", "codecs",
]
