"""Where the tensor-parallel path's f32 gaps against one device come
from, at full width on the CPU: the split and the one-device computation
run twice from the same weights, in f32 and in f64 (the stage-path
modules' ``torch.float32`` made float64, as
``test_torch_train.py::test_stage_bwd_at_jax_init_is_f32_rounding``
does).  Rounding alone leaves the f64 gap about 1e-9 of the f32 one; a
fault of the split would show in f64 as in f32.  Each check asserts
that the f32 gap is at least 1e3 times the f64 gap and that the f64 gap
is at most 1e-9 of the largest entry.

* C1: yi-6b's attention and FFN widths (d 4,096, 32 heads, 4 kv heads,
  d_ff 11,008) at 2 layers and the port's unscaled init, the vocabulary
  cut to 4,096 (it does not enter the attention), one row of 512 tokens,
  prefill logits over ``model`` 2 against one device.
* C2: swarm-1b-bottleneck's middle stage at full width (its shared layer
  applied three times, the fewest whose f32 gradient gap passes 1e-4),
  on ``(1, 2)``, one row of 64 tokens: the stage's input cotangent and
  every parameter gradient against one device.
"""
import ctypes
import gc
import importlib
import math
import os

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist import mesh as M
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import stage_param_shardings
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as model_lib
from repro_torch.models import params as P
from repro_torch.runtime.numeric import get_stage_programs
from repro_torch.runtime.stage_model import _make_stage_fwd
from repro_torch.train import steps as S
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

CPU = torch.device("cpu")
SEQ = 512
# C2's row: its f32 gap passes 1e-4 at 64 tokens (1.5e-3)
C2_SEQ = 64
# the modules whose f32 intermediates the split and one-device paths name
# ``torch.float32``
F32_MODULES = (
    "repro_torch.models.layers", "repro_torch.models.flash",
    "repro_torch.models.rope", "repro_torch.models.attention",
    "repro_torch.models.model",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.rmsnorm.ops", "repro_torch.kernels.rmsnorm.ref",
    "repro_torch.compression.bottleneck", "repro_torch.runtime.stage_model",
    "repro_torch.dist.tensor_parallel", "repro_torch.train.steps")


class _F64Torch:
    """``torch`` with ``float32`` meaning float64."""
    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def _f64(monkeypatch):
    for m in F32_MODULES:
        monkeypatch.setattr(importlib.import_module(m), "torch", _F64Torch())


@pytest.fixture
def threads():
    """The cores the other five of tier-1's six one-thread workers leave
    free, at least one, as threads for the full-width products (the
    file's default is one, as in tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) - 5))
    yield
    torch.set_num_threads(n)


def _init(specs, seed: int):
    """``P.init``'s rule (zeros, ones, unit-normal embeddings, weights at
    ``scale / sqrt(fan_in)``, unscaled), drawn from a seeded generator,
    clipped at 2 (``trunc_normal_`` takes a minute at these widths on
    the CPU)."""
    gen = torch.Generator().manual_seed(seed)

    def one(spec):
        if spec.init in ("zeros", "ones"):
            return torch.full(spec.shape, float(spec.init == "ones"))
        a = torch.randn(spec.shape, generator=gen)
        if spec.init != "embed":
            a.clamp_(-2, 2).mul_(spec.scale / math.sqrt(
                P._fan_in(spec.shape)))
        return a
    return tree_map(one, specs, is_leaf=P.is_spec)


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max |a - b| / max |b|``, in f64 (one temporary)."""
    d = a.double() - b.double()
    return float(d.abs_().max()) / float(b.abs().max())


def _attributed(gap32: float, gap64: float) -> None:
    assert gap64 <= 1e-9, gap64
    assert gap32 >= 1e3 * gap64, (gap32, gap64)


# -------------------------------------------------------------------- C1
def _c1_logits(cfg, params, tokens):
    """Prefill logits ``[1, S, V]`` of the split (``model`` 2) and of one
    device."""
    mesh = make_debug_mesh((1, 2), ("data", "model"), devices=[CPU] * 2)
    sh = stage_param_shardings(S.model_specs(cfg), mesh)
    placed = tree_map(M.place_as, params, sh)
    trees = [tp.gather_block(placed, CPU, j) for j in range(2)]
    group = tp.Group.of(mesh, data=0)
    with torch.no_grad():
        one, _ = model_lib.lm_prefill(cfg, params, tokens, last_only=False)
        (parts,), _ = model_lib.lm_prefill_tp(cfg, [trees], [group],
                                              [tokens], last_only=False)
    return torch.cat(parts, -1), one


def test_c1_serving_split_gap_is_f32_rounding(monkeypatch, threads):
    """C1 (ROADMAP queue 3): the unscaled yi-6b widths' f32 gap between
    prefill over ``model`` 2 and one device is rounding."""
    cfg = get_config("yi-6b").with_overrides(n_layers=2, vocab_size=4096,
                                             compute_dtype="float32")
    params = _init(S.model_specs(cfg), 0)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ),
                           generator=torch.Generator().manual_seed(1))
    split32, one32 = _c1_logits(cfg, params, tokens)
    gap32 = _gap(split32, one32)
    _f64(monkeypatch)
    f64 = dict(compute_dtype="float64", param_dtype="float64")
    split64, one64 = _c1_logits(cfg.with_overrides(**f64), tree_map(
        lambda a: a.double(), params), tokens)
    monkeypatch.undo()
    assert split64.dtype == torch.float64
    _attributed(gap32, _gap(split64, one64))


# -------------------------------------------------------------------- C2
def _trim() -> None:
    """Hand the freed heap back to the system (glibc keeps a full-width
    backward's freed blocks, which the next pass's peak would stack on)."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass


def _leaf_groups(leaves: list) -> list:
    """``leaves`` in two groups, for one backward each: the largest that
    fit in half the parameters, and the rest."""
    half, n = [], 0
    for t in sorted(leaves, key=torch.numel, reverse=True):
        if 2 * (n + t.numel()) <= sum(map(torch.numel, leaves)):
            half.append(t)
            n += t.numel()
    return [half, [t for t in leaves if all(t is not h for h in half)]]


def _c2_pass(cfg, params, x, dy) -> list:
    """The middle stage's forward and backward on ``(1, 2)`` (the model
    shards' blocks placed and gathered from the same parameter leaves)
    seeded with ``-dy``, then on one device (a backward a group of
    leaves, :func:`_leaf_groups`, over one forward): the leaves' gradients
    accumulate ``g_one - g_split`` in place, so no third gradient tree
    is made, and the split's gathered blocks and their gradients are
    gone before the one-device pass starts.  Per input cotangent and
    parameter gradient: ``(max |g_one - g_split|, max |g_split|)``."""
    fwd = _make_stage_fwd(cfg, 1, 3, "bottleneck", True)
    mesh = make_debug_mesh((1, 2), ("data", "model"), devices=[CPU] * 2)
    sh = stage_param_shardings(
        get_stage_programs(cfg, 3, C2_SEQ, "bottleneck")[1].specs, mesh)
    leaves = tree_leaves(tree_map(lambda a: a.detach().requires_grad_(),
                                  params))
    tree = tree_unflatten_like(params, leaves)
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    with torch.enable_grad():
        placed = tree_map(M.place_as, tree, sh)
        ms = tp.ModelShards([tp.gather_block(placed, CPU, j)
                             for j in range(2)], tp.Group.of(mesh, data=0))
        y = fwd([ms], [x2])[0]
        del ms, placed
        (-(y * dy.to(y.dtype)).sum()).backward()
    del y
    scales = [float(t.grad.abs().max()) for t in [x2] + leaves]
    _trim()
    # one device, a backward a group of leaves over one forward: the
    # shared layer's gradient buffers hold one group at a time, not the
    # whole tree
    groups = _leaf_groups(leaves)
    with torch.enable_grad():
        out = (fwd([tree], [x1])[0] * dy.to(x.dtype)).sum()
        for k, group in enumerate(groups):
            out.backward(inputs=group + ([x1] if k == 0 else []),
                         retain_graph=k < len(groups) - 1)
    del out
    # the input's two cotangents: + g_one and - g_split
    diffs = [float((x1.grad + x2.grad).abs().max())] + [
        float(t.grad.abs().max()) for t in leaves]
    return list(zip(diffs, scales))


def test_c2_stage_gradient_gap_is_f32_rounding(monkeypatch, threads):
    """C2 (ROADMAP queue 3): swarm-1b-bottleneck's full-width middle
    stage over ``model`` 2: the gaps of its input cotangent and
    gradients against one device, each of the split leaf's largest
    entry, are rounding, with the shared layer applied three times, on one row of
    64 tokens (the largest f32 gap then passes 1e-4: 8.7e-5 at two,
    1.6e-2 at four)."""
    cfg = get_config("swarm-1b-bottleneck").with_overrides(
        n_layers=9, compute_dtype="float32")
    specs = get_stage_programs(cfg, 3, C2_SEQ, "bottleneck")[1].specs
    params = _init(specs, 2)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, C2_SEQ, cfg.bottleneck_dim), generator=g)
    dy = torch.randn((1, C2_SEQ, cfg.bottleneck_dim), generator=g)
    gaps32 = [d / s for d, s in _c2_pass(cfg, params, x, dy)]
    params = tree_map(lambda a: a.double(), params)
    _trim()
    _f64(monkeypatch)
    f64 = dict(compute_dtype="float64", param_dtype="float64")
    gaps64 = [d / s for d, s in _c2_pass(
        cfg.with_overrides(**f64), params, x.double(), dy.double())]
    monkeypatch.undo()
    assert max(gaps32) >= 1e-4
    _attributed(max(gaps32), max(gaps64))
    for g32, g64 in zip(gaps32, gaps64):
        assert g64 <= 1e-9 and (g32 >= 1e3 * g64 or g32 == g64 == 0.0)
