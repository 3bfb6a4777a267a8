"""Rotary position embeddings (port of ``repro.models.rope``; standard
RoPE only — M-RoPE comes with the VLM slice)."""
from __future__ import annotations

import torch


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / dim))


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """positions [..., S] -> angles [..., S, dim//2]."""
    f = rope_freqs(dim, theta, device=positions.device)
    return positions[..., None].to(torch.float32) * f


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    # x [..., D]; rotate interleaved-as-halves (llama convention), in the
    # promoted (f32) type like jnp, then back to x's dtype
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, S, H, D], positions [S] or [B, S]."""
    ang = rope_angles(positions, x.shape[-1], theta)     # [.., S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if cos.ndim == 2:                                    # [S, D/2]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                                                # [B, S, D/2]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return _rotate(x, cos, sin)
