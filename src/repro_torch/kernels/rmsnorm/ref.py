"""Plain PyTorch version of fused RMSNorm (port of
``repro.kernels.rmsnorm.ref``).

The mean square is summed in float64 and rounded once to float32, so it
is the correctly rounded f32 mean whatever order the sum runs in — the
CUDA kernel does the same, and the two then agree to the bit.  The rest
is the JAX oracle's f32 arithmetic.
"""
import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    x64 = x32.to(torch.float64)
    var = (x64 * x64).mean(-1, keepdim=True).to(torch.float32)
    return (x32 * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)
