"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE (port
of ``repro.models.rope``)."""
from __future__ import annotations

import torch

# M-RoPE splits the rotary half-dim into (temporal, height, width) sections.
MROPE_SECTIONS = (16, 24, 24)


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=None) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x [B, S, H, D]; positions [3, B, S]
    (t/h/w streams; text tokens carry identical t = h = w positions).
    Each section of the rotary half-dim rotates by its own stream: by
    default Qwen2-VL's split at head dim 128, else the same
    1/4 : 3/8 : 3/8 ratio."""
    d2 = x.shape[-1] // 2
    if sections is None:
        if d2 == sum(MROPE_SECTIONS):
            sections = MROPE_SECTIONS
        else:
            t = d2 // 4
            h = (d2 - t) // 2
            sections = (t, h, d2 - t - h)
    if sum(sections) != d2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to the "
                         f"rotary half-dim {d2}")
    if positions.ndim != 3 or positions.shape[0] != 3:
        raise ValueError(f"M-RoPE positions must be [3, B, S], got "
                         f"{tuple(positions.shape)}")
    f = rope_freqs(x.shape[-1], theta, device=positions.device)   # [D/2]
    ang = positions[..., None].to(torch.float32) * f            # [3,B,S,D/2]
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang[i, :, :, start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                              # [B, S, D/2]
    return _rotate(x, torch.cos(ang)[:, :, None, :],
                   torch.sin(ang)[:, :, None, :])


def default_mrope_positions(batch: int, seq: int, offset=0,
                            device=None) -> torch.Tensor:
    """Text-only positions: all three streams share ``offset + arange``,
    ``[3, batch, seq]``."""
    p = offset + torch.arange(seq, device=device)
    return p.expand(3, batch, seq)
