"""Recurrent sequence mixers: Mamba selective SSM, xLSTM (mLSTM + sLSTM)
(port of ``repro.models.ssm``).

Plain PyTorch throughout: the JAX package computes these mixers in
``jnp`` outside any Pallas kernel.  The full-sequence paths are
chunkwise (memory O(chunk), FLOPs linear in T); the decode paths are
O(1)-state single-step recurrences.  Dtypes follow the JAX package: the
projections run in the activation dtype, the recurrences and their
states in f32 (sLSTM's ``h`` in the activation dtype), and Mamba's
``a_log`` and ``d_skip`` are f32 whatever ``param_dtype`` is.

Three differences of form, none of value:

* JAX's in-chunk ``jax.lax.associative_scan`` is a log-depth doubling
  scan here (:func:`_doubling_scan`), ⌈log2 c⌉ steps over the chunk in
  f32: the same prefix products, summed in another order (within 1e-5
  of JAX in f32, ``tests/test_torch_ssm.py``).
* ``apply_mamba`` and ``apply_mlstm`` take any ``T >= 1``: full chunks of
  ``c = min(chunk, T)``, then one last chunk of ``T mod c``.  Where ``T``
  is a multiple of ``c`` the chunking is JAX's; where it is not, JAX
  asserts (``nc * c == T``).  A recovery prefill of ``prompt + decoded``
  tokens needs those lengths (ROADMAP queue 3, deliberate difference
  5).  Mamba's scan then gives JAX's value with ``chunk = T``; so do
  mLSTM's state and last output, while its earlier outputs follow the
  chunking, as JAX's do: it normalises a chunk's outputs at the
  stabiliser of the chunk's end.
* The decode paths write their new state into the cache they are given,
  in place (as ``layers.apply_attn_decode`` writes its KV row), and
  return that cache: a serving session owns its caches exclusively, and
  the stacked per-layer caches need no restacking.

Under autograd each chunk runs under ``torch.utils.checkpoint``, as JAX
wraps it in ``jax.checkpoint``: backward keeps only the carry of every
chunk, not its ``[B, c, di, N]`` (Mamba) or ``[B, H, c, c]`` (mLSTM)
intermediates.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.models.probe import probe_enabled

Tree = Any
f32 = torch.float32


def _chunks(T: int, chunk: int) -> list[tuple[int, int]]:
    """``(start, length)`` of each chunk: full chunks of ``min(chunk, T)``,
    then the remainder."""
    c = min(chunk, T)
    out = [(i, c) for i in range(0, T - T % c, c)]
    if T % c:
        out.append((T - T % c, T % c))
    return out


def _scan_chunks(step: Callable, carry: tuple, xs: list, T: int,
                 chunk: int):
    """Run ``step(*carry, *chunk_of_xs) -> (*carry, y)`` over the sequence
    axis (1) of every tensor of ``xs`` chunk by chunk, each chunk
    rematerialised in backward when gradients flow; returns the final
    carry and the ``y``s concatenated along axis 1."""
    ys = []
    for start, c in _chunks(T, chunk):
        args = (*carry, *(x[:, start:start + c] for x in xs))
        if torch.is_grad_enabled():
            out = checkpoint(step, *args, use_reentrant=False)
        else:
            out = step(*args)
        carry, y = out[:-1], out[-1]
        ys.append(y)
    return carry, torch.cat(ys, dim=1)


# ================================================================ Mamba
def mamba_specs(cfg: ArchConfig, d: int | None = None) -> Tree:
    s = cfg.ssm
    d = d or cfg.d_model
    di = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    pd = cfg.param_jdtype
    return {
        "w_in": ParamSpec((d, 2 * di), pd, axes=("embed", "mlp")),
        "conv_w": ParamSpec((s.conv_kernel, di), pd, axes=("conv", "mlp")),
        "conv_b": ParamSpec((di,), pd, "zeros", ("mlp",)),
        "w_x": ParamSpec((di, dtr + 2 * s.state_dim), pd,
                         axes=("mlp", "state")),
        "w_dt": ParamSpec((dtr, di), pd, axes=("state", "mlp")),
        "b_dt": ParamSpec((di,), pd, "zeros", ("mlp",)),
        "a_log": ParamSpec((di, s.state_dim), f32, "zeros",
                           ("mlp", "state")),
        "d_skip": ParamSpec((di,), f32, "ones", ("mlp",)),
        "w_out": ParamSpec((di, d), pd, axes=("mlp", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. u [B, T, C], w [K, C]: JAX's K-term loop,
    in its order."""
    K, T = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for k in range(K):
        out = out + up[:, k:k + T] * w[k]
    return out + b


def _mamba_inner(cfg: ArchConfig, p: Tree, x: torch.Tensor):
    """The input projection: (u, z, dt_rank, d_inner)."""
    s = cfg.ssm
    d = x.shape[-1]
    di = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    uz = x @ p["w_in"].to(x.dtype)
    return uz[..., :di], uz[..., di:], dtr, di


def _selective_inputs(cfg: ArchConfig, p: Tree, u: torch.Tensor, dtr: int):
    """(dt f32, B, C) from the convolved ``u``."""
    s, cd = cfg.ssm, u.dtype
    xp = u @ p["w_x"].to(cd)
    dt_lr = xp[..., :dtr]
    Bm = xp[..., dtr:dtr + s.state_dim]
    Cm = xp[..., dtr + s.state_dim:]
    dt = F.softplus(dt_lr @ p["w_dt"].to(cd) + p["b_dt"].to(cd)).to(f32)
    return dt, Bm, Cm


def _doubling_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``(a, b)`` along axis 1 under ``combine((a1, b1),
    (a2, b2)) = (a2 a1, a2 b1 + b2)`` (``(a1, b1)`` the earlier): Hillis
    and Steele's doubling, ⌈log2 c⌉ steps; returns (prefix products of
    ``a``, the scanned ``b``).  On meta tensors, :class:`_MetaScan`."""
    if a.device.type == "meta":
        return _MetaScan.apply(a, b)
    c, shift = a.shape[1], 1
    while shift < c:
        a_hi = a[:, shift:]
        b = torch.cat([b[:, :shift], a_hi * b[:, :-shift] + b[:, shift:]], 1)
        a = torch.cat([a[:, :shift], a_hi * a[:, :-shift]], 1)
        shift *= 2
    return a, b


class _MetaScan(torch.autograd.Function):
    """:func:`_doubling_scan` on meta tensors (the dry run): each step's
    allocations in the loop's order (two products and a sum of ``c -
    shift`` rows, two ``c``-row concatenations; under autograd each
    step's ``a`` and ``b`` saved, two gradients a step in backward) and
    the bytes its ops move, reported as work; not its element-wise ops,
    which compute nothing on meta and cost ~0.3 ms of shape logic each
    (a 32,768-token Mamba layer ran 5 s)."""

    @staticmethod
    def forward(ctx, a, b):
        from repro_torch import kernels
        c, shift, saved, moved = a.shape[1], 1, [], 0
        row = a[:, :1].numel() * a.element_size()
        while shift < c:
            part = (*a.shape[:1], c - shift, *a.shape[2:])
            t = a.new_empty(part)                    # a_hi * b[:, :-shift]
            t = a.new_empty(part)                    # ... + b[:, shift:]
            saved += [a, b]
            b = a.new_empty(a.shape)                 # torch.cat
            t = a.new_empty(part)                    # a_hi * a[:, :-shift]
            a = a.new_empty(a.shape)                 # torch.cat
            del t
            moved += (3 * 3 * (c - shift) + 2 * 2 * c) * row
            shift *= 2
        kernels.report_work("doubling_scan", 0.0, moved)
        ctx.save_for_backward(*saved)
        return a, b

    @staticmethod
    def backward(ctx, ga, gb):
        for t in ctx.saved_tensors[::2]:
            ga, gb = torch.empty_like(t), torch.empty_like(t)
        return ga, gb


def _mamba_chunk(h, uc, dtc, Bc, Cc, A):
    """One chunk of the selective scan from carry ``h`` [B, di, N]:
    returns (the carry after the chunk, y [B, c, di] f32)."""
    a = torch.exp(dtc[..., None] * A)                          # [B,c,di,N]
    bx = (dtc * uc.to(f32))[..., None] * Bc.to(f32)[:, :, None, :]
    a_acc, h_in = _doubling_scan(a, bx)
    hs = a_acc * h[:, None] + h_in                             # [B,c,di,N]
    y = torch.einsum("bcdn,bcn->bcd", hs, Cc.to(f32))
    return hs[:, -1].clone(), y


def apply_mamba(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence path. x [B, T, d] -> [B, T, d] (and, with
    ``return_state``, the decode state after the last position)."""
    s, cd = cfg.ssm, x.dtype
    B, T, _ = x.shape
    u_raw, z, dtr, di = _mamba_inner(cfg, p, x)
    u = F.silu(_causal_conv(u_raw, p["conv_w"].to(cd), p["conv_b"].to(cd)))
    dt, Bm, Cm = _selective_inputs(cfg, p, u, dtr)
    A = -torch.exp(p["a_log"])                                 # [di, N]
    h0 = torch.zeros(B, di, s.state_dim, dtype=f32, device=x.device)
    (h_last,), y = _scan_chunks(
        lambda h, uc, dtc, Bc, Cc: _mamba_chunk(h, uc, dtc, Bc, Cc, A),
        (h0,), [u, dt, Bm, Cm], T, T if probe_enabled() else s.chunk)
    y = (y + u.to(f32) * p["d_skip"]).to(cd)
    y = y * F.silu(z)
    out = y @ p["w_out"].to(cd)
    if return_state:
        K = s.conv_kernel
        tail = F.pad(u_raw, (0, 0, max(0, K - 1 - T), 0))[:, -(K - 1):]
        return out, {"h": h_last, "conv": tail.to(cfg.compute_jdtype)}
    return out


def mamba_cache_specs(cfg: ArchConfig, batch: int,
                      d: int | None = None) -> Tree:
    s = cfg.ssm
    d = d or cfg.d_model
    di = s.expand * d
    return {
        "h": ParamSpec((batch, di, s.state_dim), f32, "zeros",
                       ("batch", "mlp", "state")),
        "conv": ParamSpec((batch, s.conv_kernel - 1, di), cfg.compute_jdtype,
                          "zeros", ("batch", "conv", "mlp")),
    }


def apply_mamba_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                       cache: Tree):
    """One-step decode. x [B, 1, d]; the cache's state is advanced in
    place."""
    cd = x.dtype
    u, z, dtr, _ = _mamba_inner(cfg, p, x)
    u, z = u[:, 0], z[:, 0]
    window = torch.cat([cache["conv"].to(cd), u[:, None]], dim=1)  # [B,K,di]
    uc = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"].to(cd))
                + p["conv_b"].to(cd))
    dt, Bm, Cm = _selective_inputs(cfg, p, uc, dtr)
    A = -torch.exp(p["a_log"])
    a = torch.exp(dt[..., None] * A)                           # [B, di, N]
    h = a * cache["h"] + (dt * uc.to(f32))[..., None] \
        * Bm.to(f32)[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm.to(f32))
    y = (y + uc.to(f32) * p["d_skip"]).to(cd)
    y = y * F.silu(z)
    out = (y @ p["w_out"].to(cd))[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return out, cache


# ================================================================ mLSTM
# Matrix-memory LSTM == decay-gated linear attention; the normaliser n is
# folded in as an extra value column of ones.
def mlstm_specs(cfg: ArchConfig) -> Tree:
    d, H, pd = cfg.d_model, cfg.n_heads, cfg.param_jdtype
    hd = d // H
    return {
        "wq": ParamSpec((d, H, hd), pd, axes=("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, H, hd), pd, axes=("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, H, hd), pd, axes=("embed", "heads", "head_dim")),
        "w_if": ParamSpec((d, H, 2), pd, "zeros", ("embed", "heads", "null")),
        "b_if": ParamSpec((H, 2), pd, "zeros", ("heads", "null")),
        "w_og": ParamSpec((d, d), pd, axes=("embed", "embed2")),
        "wo": ParamSpec((H, hd, d), pd, axes=("heads", "head_dim", "embed")),
    }


def _mlstm_chunk(C_in, m_in, qb, kb, vb, li, lf):
    """One chunk from carry (C [B,H,hd,hd+1], m [B,H]) with the chunk's
    own stabiliser: returns (C, m, y [B,c,H,hd+1] f32)."""
    cd = qb.dtype
    c = qb.shape[1]
    csum = torch.cumsum(lf, dim=1)                             # [B,c,H]
    total = csum[:, -1]
    m_intra = torch.amax(li - csum, dim=1)                     # [B,H]
    m_new = torch.maximum(m_in + total, m_intra + total)
    # inter-chunk, at the chunk's stabiliser (every exp <= 1)
    d_q = torch.exp(csum + (m_in - m_new)[:, None])            # [B,c,H]
    y_inter = torch.einsum("bihk,bhkv->bihv", qb.to(f32), C_in) \
        * d_q[..., None]
    # intra-chunk: d_ij = exp(csum_i - csum_j + li_j - m_new), j <= i
    gk = torch.exp(li - csum - m_new[:, None])                 # [B,c,H]
    s = torch.einsum("bihk,bjhk->bhij", qb, kb)
    dmat = torch.exp(csum).transpose(1, 2)[:, :, :, None] \
        * gk.transpose(1, 2)[:, :, None, :]                    # [B,H,i,j]
    mask = torch.ones(c, c, dtype=torch.bool, device=qb.device).tril()
    s = torch.where(mask, s * dmat, 0.0)
    y_intra = torch.einsum("bhij,bjhv->bihv", s.to(cd), vb)
    y = y_inter.to(f32) + y_intra.to(f32)
    # C' = exp(total + m_in - m_new) C_in + sum_j gk'_j k_j v_j
    gk_state = torch.exp(li + (total[:, None] - csum) - m_new[:, None])
    C_new = torch.exp(m_in + total - m_new)[:, :, None, None] * C_in + \
        torch.einsum("bjhk,bjhv,bjh->bhkv", kb, vb, gk_state.to(cd))
    return C_new, m_new, y


def _mlstm_gates(p: Tree, x: torch.Tensor, eq: str):
    gates = torch.einsum(eq, x, p["w_if"].to(x.dtype)) + p["b_if"].to(x.dtype)
    return gates[..., 0].to(f32), F.logsigmoid(gates[..., 1].to(f32))


def _mlstm_out(p: Tree, x: torch.Tensor, y: torch.Tensor, hd: int, eq: str):
    """Normalise by the ones column, gate, project out."""
    num, den = y[..., :hd], y[..., hd:]
    y = num / torch.clamp(den.abs(), min=1.0)
    og = F.silu(x @ p["w_og"].to(x.dtype))
    return torch.einsum(eq, y.to(x.dtype), p["wo"].to(x.dtype)) * og


def apply_mlstm(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                return_state: bool = False):
    """Chunkwise-parallel mLSTM. x [B, T, d]."""
    cd = x.dtype
    B, T, d = x.shape
    H = cfg.n_heads
    hd = d // H
    chunk = T if probe_enabled() else (cfg.ssm.chunk if cfg.ssm else 128)
    proj = lambda w: torch.einsum("btd,dhk->bthk", x, p[w].to(cd))
    q = proj("wq") * hd ** -0.5
    k = proj("wk") * hd ** -0.5
    v = torch.cat([proj("wv"), x.new_ones(B, T, H, 1)], -1)   # normaliser
    logi, logf = _mlstm_gates(p, x, "btd,dhg->bthg")
    C0 = torch.zeros(B, H, hd, hd + 1, dtype=f32, device=x.device)
    m0 = torch.zeros(B, H, dtype=f32, device=x.device)
    (C_f, m_f), y = _scan_chunks(_mlstm_chunk, (C0, m0),
                                 [q, k, v, logi, logf], T, chunk)
    out = _mlstm_out(p, x, y, hd, "bthk,hkd->btd")
    if return_state:
        return out, {"C": C_f, "m": m_f}
    return out


def mlstm_cache_specs(cfg: ArchConfig, batch: int) -> Tree:
    H = cfg.n_heads
    hd = cfg.d_model // H
    return {
        "C": ParamSpec((batch, H, hd, hd + 1), f32, "zeros",
                       ("batch", "heads", "head_dim", "v_dim")),
        "m": ParamSpec((batch, H), f32, "zeros", ("batch", "heads")),
    }


def apply_mlstm_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                       cache: Tree):
    """One-step decode. x [B, 1, d]; (C, m) advanced in place."""
    cd = x.dtype
    B = x.shape[0]
    H = cfg.n_heads
    hd = cfg.d_model // H
    xt = x[:, 0]
    proj = lambda w: torch.einsum("bd,dhk->bhk", xt, p[w].to(cd))
    q = proj("wq") * hd ** -0.5
    k = proj("wk") * hd ** -0.5
    v = torch.cat([proj("wv"), xt.new_ones(B, H, 1)], -1)
    logi, logf = _mlstm_gates(p, xt, "bd,dhg->bhg")
    m_new = torch.maximum(logf + cache["m"], logi)
    fp = torch.exp(logf + cache["m"] - m_new)
    ip = torch.exp(logi - m_new)
    C = fp[..., None, None] * cache["C"] + \
        ip[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v).to(f32)
    y = torch.einsum("bhk,bhkv->bhv", q.to(f32), C)
    out = _mlstm_out(p, xt, y, hd, "bhk,hkd->bd")
    cache["C"].copy_(C)
    cache["m"].copy_(m_new)
    return out[:, None], cache


# ================================================================ sLSTM
def slstm_specs(cfg: ArchConfig) -> Tree:
    d, H, pd = cfg.d_model, cfg.n_heads, cfg.param_jdtype
    hd = d // H
    return {
        "w": ParamSpec((d, H, 4 * hd), pd,
                       axes=("embed", "heads", "head_dim")),
        "r": ParamSpec((H, hd, 4 * hd), pd,
                       axes=("heads", "head_dim", "null")),
        "b": ParamSpec((H, 4 * hd), pd, "zeros", ("heads", "head_dim")),
        "wo": ParamSpec((d, d), pd, axes=("embed", "embed2")),
    }


def _slstm_cell(p_r, p_b, wx_t, state):
    """One sLSTM step. wx_t [B,H,4hd]; state (c, n, h, m) each [B,H,hd]
    (c, n, m f32; h in the activation dtype)."""
    c, n, h, m = state
    pre = wx_t + torch.einsum("bhk,hkg->bhg", h, p_r) + p_b
    zi, ii, fi, oi = torch.chunk(pre.to(f32), 4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    logf = F.logsigmoid(fi)
    m_new = torch.maximum(logf + m, ii)
    ip = torch.exp(ii - m_new)
    fp = torch.exp(logf + m - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new.to(wx_t.dtype), m_new


def apply_slstm(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                return_state: bool = False):
    """Sequential sLSTM (memory mixing forbids a parallel scan): one cell
    step per position. x [B, T, d].

    On a meta tensor (the dry run) there is no value to carry from one
    step to the next, so the T cell steps run as one step over ``B * T``
    rows: the same shapes, products and saved tensors as the loop, in
    one call instead of T (the loop took 39 s a layer at T = 4,096)."""
    cd = x.dtype
    B, T, d = x.shape
    H = cfg.n_heads
    hd = d // H
    wx = torch.einsum("btd,dhg->bthg", x, p["w"].to(cd))
    r, b = p["r"].to(cd), p["b"].to(cd)
    if x.device.type == "meta":
        return _slstm_meta(p, wx, r, b, return_state)
    zero = torch.zeros(B, H, hd, dtype=f32, device=x.device)
    state = (zero, zero, torch.zeros(B, H, hd, dtype=cd, device=x.device),
             zero)
    hs = []
    for t in range(T):
        state = _slstm_cell(r, b, wx[:, t], state)
        hs.append(state[2])
    y = torch.stack(hs, dim=1).reshape(B, T, d)
    out = y @ p["wo"].to(cd)
    if return_state:
        c, n, h, m = state
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out


def _slstm_meta(p: Tree, wx: torch.Tensor, r: torch.Tensor,
                b: torch.Tensor, return_state: bool):
    """:func:`apply_slstm`'s T steps as one cell step over ``B * T`` rows
    (meta tensors only: the carried values do not exist there)."""
    B, T, H, g = wx.shape
    hd, cd = g // 4, wx.dtype
    zeros = lambda dt: torch.zeros(1, H, hd, dtype=dt,
                                   device=wx.device).expand(B * T, H, hd)
    state = _slstm_cell(r, b, wx.reshape(B * T, H, g),
                        (zeros(f32), zeros(f32), zeros(cd), zeros(f32)))
    out = state[2].reshape(B, T, H * hd) @ p["wo"].to(cd)
    if return_state:
        c, n, h, m = (t.reshape(B, T, H, hd)[:, -1] for t in state)
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out


def slstm_cache_specs(cfg: ArchConfig, batch: int) -> Tree:
    H = cfg.n_heads
    hd = cfg.d_model // H
    mk = lambda dt: ParamSpec((batch, H, hd), dt, "zeros",
                              ("batch", "heads", "head_dim"))
    return {"c": mk(f32), "n": mk(f32), "h": mk(cfg.compute_jdtype),
            "m": mk(f32)}


def apply_slstm_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                       cache: Tree):
    """One-step decode. x [B, 1, d]; (c, n, h, m) advanced in place."""
    cd = x.dtype
    wx = torch.einsum("bd,dhg->bhg", x[:, 0], p["w"].to(cd))
    keys = ("c", "n", "h", "m")
    new = _slstm_cell(p["r"].to(cd), p["b"].to(cd), wx,
                      tuple(cache[k] for k in keys))
    y = new[2].reshape(x.shape[0], -1) @ p["wo"].to(cd)
    for key, val in zip(keys, new):
        cache[key].copy_(val)
    return y[:, None], cache
