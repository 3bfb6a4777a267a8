"""The port's single-process training path against the JAX package on
the same numpy inputs: ``cross_entropy``, ``lm_apply`` (dense, shared
groups, M-RoPE positions, MoE aux) and its remat modes, the loss
function's gradients per leaf, ``_split_microbatches``, whole
``make_train_step`` trajectories for every assigned architecture and
swarm-1b at ``get_reduced`` size (with accumulation, LAMB and DPU), and
the meta-device ``input_specs`` leaf for leaf against JAX's
``ShapeDtypeStruct``s at full size.

Weights are drawn in numpy with JAX's init rules and every attention's
``wq``/``wk`` scaled by ``ATTN_SCALE`` (``tests/test_torch_train.py``
says why); JAX's functions are jitted.  Bounds: logits and aux within
``TOL`` of the tensor's scale; gradients ``GRAD_RTOL`` of the leaf's
largest entry; a step-1 loss within ``STEP1_RTOL`` relative and three
steps' losses within ``TRAJ_ATOL``; the remat modes equal to the bit.
Serial time ≈ 60 s on one CPU core.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config
from repro.configs import ASSIGNED, REGISTRY as J_REGISTRY, SHAPES, \
    get_config as j_get_config, get_reduced
from repro.models import model as jm
from repro.optim import adamw as j_adamw, lamb as j_lamb, \
    delayed_parameter_updates as j_dpu
from repro.train import steps as js

from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import model as tm
from repro_torch.models.params import from_numpy_tree
from repro_torch.optim import adamw, delayed_parameter_updates, lamb
from repro_torch.train import steps as ts
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

from test_torch_families import _numpy_init, assert_close, port_cfg
from test_torch_train import ATTN_SCALE, GRAD_RTOL, TRAJ_ATOL, _close_rel

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

TOL = 1e-5
STEP1_RTOL = 1e-5
CE_TOL = 1e-6
SEQ, BATCH = 16, 4
MODES = ["none", "block", "2level"]


def _scale_attention(tree):
    """Every ``wq``/``wk`` under an ``attn`` / ``xattn`` key scaled by
    ATTN_SCALE, in place."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            if key in ("attn", "xattn") and isinstance(sub, dict):
                for w in ("wq", "wk"):
                    if w in sub:
                        sub[w] = sub[w] * np.float32(ATTN_SCALE)
            else:
                _scale_attention(sub)
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            _scale_attention(sub)
    return tree


def _shared(cfg, seed=0):
    """(JAX params, port params) of the same numpy weights."""
    host = _scale_attention(_numpy_init(js.model_specs(cfg), seed))
    return jax.tree.map(jnp.asarray, host), from_numpy_tree(host, "cpu")


def _batch(cfg, seed, batch=BATCH, seq=SEQ):
    """A numpy batch: tokens, labels, and M-RoPE positions (three
    distinct monotone axes) or audio frames where the config reads
    them."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                dtype=np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (batch, seq),
                                dtype=np.int32)}
    if cfg.rope == "mrope":
        steps = rng.integers(0, 3, (3, batch, seq))
        b["positions"] = np.cumsum(steps, axis=-1).astype(np.int32)
    if cfg.family == "audio":
        b["audio_embed"] = rng.standard_normal(
            (batch, cfg.encoder_max_len, cfg.d_model)).astype(np.float32)
    return b


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------ cross entropy
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((2, 8, 512))).astype(np.float32)
    labels = rng.integers(0, 512, (2, 8), dtype=np.int32)
    jl = jnp.asarray(logits).astype(dtype)
    want = float(jax.jit(js.cross_entropy)(jl, jnp.asarray(labels)))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = float(ts.cross_entropy(tl, torch.from_numpy(labels)))
    assert abs(got - want) <= CE_TOL * abs(want)


# ------------------------------------------------------------ lm_apply
def _lm_configs():
    swarm = get_reduced("swarm-1b").with_overrides(n_layers=4)
    assert swarm.n_layers // swarm.share_groups == 2     # reps > 1
    return {"dense": tiny_dense_config(), "shared": swarm,
            "mrope": get_reduced("qwen2-vl-2b"),
            "moe": get_reduced("llama4-scout-17b-a16e"),
            "audio": get_reduced("whisper-large-v3")}


@pytest.mark.parametrize("name", ["dense", "shared", "mrope", "moe"])
def test_lm_apply_matches_jax(name):
    cfg = _lm_configs()[name]
    jp, tp = _shared(cfg)
    b = _batch(cfg, 1)
    jl, ja = jax.jit(lambda p, t, pos: jm.lm_apply(cfg, p, t, pos))(
        jp, jnp.asarray(b["tokens"]),
        None if "positions" not in b else jnp.asarray(b["positions"]))
    tb = _t(b)
    for mode in MODES:
        tl, ta = tm.lm_apply(port_cfg(cfg), tp, tb["tokens"],
                             tb.get("positions"), remat=mode)
        assert_close(tl.detach().numpy(), jl, TOL)
        assert_close(float(ta), float(ja), TOL)
    if name == "moe":
        assert float(ja) > 0


def _grads(cfg, params, batch, remat):
    leaves = [a.detach().requires_grad_() for a in tree_leaves(params)]
    loss, _ = ts.make_loss_fn(cfg, remat)(
        tree_unflatten_like(params, leaves), batch)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("name", ["dense", "shared", "mrope", "moe",
                                  "audio"])
def test_remat_modes_equal_none_to_the_bit(name):
    cfg = port_cfg(_lm_configs()[name])
    _, tp = _shared(_lm_configs()[name])
    batch = _t(_batch(cfg, 2))
    loss0, g0 = _grads(cfg, tp, batch, "none")
    for mode in ("block", "2level", True, False):
        loss, g = _grads(cfg, tp, batch, mode)
        assert torch.equal(loss, loss0)
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(g, g0))


def _counting(monkeypatch):
    """Count the calls of the flash and rmsnorm kernel wrappers (the
    plain versions run on the CPU; on the card each call is a launch)."""
    calls = {"flash": 0, "rmsnorm": 0}

    def wrap(mod, name, key):
        orig = getattr(mod, name)

        def counted(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    wrap(flash_kernel, "flash_attention_fwd", "flash")
    wrap(rms_ops, "rmsnorm", "rmsnorm")
    return calls


@pytest.mark.parametrize("mode", MODES)
def test_remat_saves_fewer_tensors_and_recomputes(mode, monkeypatch):
    """A 16-layer stack's forward: the tensors autograd saves (packed
    through ``saved_tensors_hooks``: a checkpoint keeps only its inputs),
    and the kernel calls of forward and backward.  ``block`` recomputes
    every layer once; ``2level`` (4 groups of 4) recomputes each group
    but its last layer, which no saved tensor of the group needs (the
    non-reentrant checkpoint stops its recompute there), and every layer
    once more in its own checkpoint."""
    cfg = tiny_dense_config(n_layers=16)
    tcfg = port_cfg(cfg)
    _, tp = _shared(cfg)
    batch = _t(_batch(cfg, 3))
    calls = _counting(monkeypatch)
    saved = []
    leaves = [a.detach().requires_grad_() for a in tree_leaves(tp)]
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        loss, _ = ts.make_loss_fn(tcfg, mode)(
            tree_unflatten_like(tp, leaves), batch)
    n_saved = len(saved)
    torch.autograd.grad(loss, leaves)
    if mode == "none":
        # one layer's forward saves 30-odd tensors; a checkpoint keeps
        # two (x, aux) a layer under block and a group under 2level
        assert n_saved > 16 * 30
    else:
        per = 16 if mode == "block" else 4
        assert 2 * per <= n_saved <= 2 * per + 10
    recomputed = {"none": 0, "block": 16, "2level": 16 + 4 * 3}
    assert calls["flash"] == 16 + recomputed[mode]
    assert calls["rmsnorm"] == 2 * (16 + recomputed[mode]) + 1


def test_sqrt_divisor_matches_jax():
    for n in range(1, 97):
        assert tm._sqrt_divisor(n) == jm._sqrt_divisor(n)


# ------------------------------------------------------- loss gradients
@pytest.mark.parametrize("name", ["dense", "shared", "mrope", "moe"])
def test_loss_fn_grads_match_jax_per_leaf(name):
    cfg = _lm_configs()[name]
    jp, tp = _shared(cfg)
    b = _batch(cfg, 4)
    (jloss, jce), jg = jax.jit(jax.value_and_grad(
        js.make_loss_fn(cfg), has_aux=True))(jp, _j(b))
    loss, g = _grads(port_cfg(cfg), tp, _t(b), "block")
    assert_close(float(loss.detach()), float(jloss), TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(g)
    for got, want in zip(g, jleaves):
        _close_rel(got.numpy(), np.asarray(want))


# ------------------------------------------------------- microbatches
@pytest.mark.parametrize("accum", [2, 4])
def test_split_microbatches_matches_jax(accum):
    rng = np.random.default_rng(5)
    b = {"tokens": rng.integers(0, 100, (8, 6), dtype=np.int32),
         "labels": rng.integers(0, 100, (8, 6), dtype=np.int32),
         "positions": rng.integers(0, 100, (3, 8, 6), dtype=np.int32),
         "audio_embed": rng.standard_normal((8, 5, 4)).astype(np.float32)}
    want = js._split_microbatches(_j(b), accum)
    got = ts._split_microbatches(_t(b), accum)
    assert sorted(got) == sorted(want)
    for k in b:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["positions"].shape == (accum, 3, 8 // accum, 6)


# ------------------------------------------------------- train steps
def _trajectories(cfg, jopt, topt, accum=1, steps=3, remat="block"):
    """Per-step losses of ``steps`` JAX and port steps from the same
    weights and batches."""
    jp, tp = _shared(cfg)
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": topt.init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(js.make_train_step(cfg, jopt, remat=remat, accum=accum))
    tstep = ts.make_train_step(port_cfg(cfg), topt, remat=remat,
                               accum=accum)
    jl, tl = [], []
    for i in range(steps):
        b = _batch(cfg, 10 + i)
        jstate, jm_ = jstep(jstate, _j(b))
        tstate, tm_ = tstep(tstate, _t(b))
        jl.append(float(jm_["loss"]))
        tl.append(float(tm_["loss"]))
        assert_close(float(tm_["ce"]), float(jm_["ce"]),
                     STEP1_RTOL if i == 0 else TRAJ_ATOL)
    assert int(tstate["step"]) == steps
    return jl, tl


def _assert_trajectory(jl, tl):
    assert abs(tl[0] - jl[0]) <= STEP1_RTOL * abs(jl[0]), (tl, jl)
    np.testing.assert_allclose(tl, jl, atol=TRAJ_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ASSIGNED + ["swarm-1b"])
def test_train_step_matches_jax(arch):
    cfg = get_reduced(arch)
    _assert_trajectory(*_trajectories(cfg, j_adamw(lr=1e-3),
                                      adamw(lr=1e-3)))


@pytest.mark.parametrize("case", ["accum2", "lamb", "dpu"])
def test_train_step_options_match_jax(case):
    cfg = get_reduced("qwen2-vl-2b")
    if case == "accum2":
        jl, tl = _trajectories(cfg, j_adamw(lr=1e-3), adamw(lr=1e-3),
                               accum=2, remat="2level")
    elif case == "lamb":
        jl, tl = _trajectories(cfg, j_lamb(lr=1e-3), lamb(lr=1e-3))
    else:
        jl, tl = _trajectories(cfg, j_dpu(j_adamw(lr=1e-3)),
                               delayed_parameter_updates(adamw(lr=1e-3)))
    _assert_trajectory(jl, tl)


def test_train_step_leaves_its_input_state():
    """The step is functional: the input state's tensors keep their
    values, and the codec pairs of a pipeline-codec config (which the
    loss never reaches) move by weight decay alone."""
    cfg = port_cfg(get_reduced("swarm-1b-bottleneck"))
    state = ts.make_state(cfg, adamw(lr=1e-3), 0, device="cpu")
    assert "boundary" in state["params"]
    before = tree_map(torch.clone, state)
    new, _ = ts.make_train_step(cfg, adamw(lr=1e-3))(
        state, _t(_batch(cfg, 6)))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(state), tree_leaves(before)))
    for p, q in zip(tree_leaves(state["params"]["boundary"]),
                    tree_leaves(new["params"]["boundary"])):
        decayed = p - 1e-3 * 0.01 * p
        torch.testing.assert_close(q, decayed, rtol=0, atol=1e-7)


# ------------------------------------------------------- input specs
def _spec_list(tree):
    return [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in tree_leaves(tree)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(J_REGISTRY))
def test_input_specs_match_jax(arch, shape):
    """Full-size configs: every input of the cell's step as a meta tensor,
    leaf for leaf the shape and dtype of JAX's ShapeDtypeStruct."""
    jcfg, tcfg = j_get_config(arch), tconfigs.get_config(arch)
    assert port_cfg(jcfg) == tcfg
    js_shape = SHAPES[shape]
    want = jax.tree.leaves(js.input_specs(jcfg, js_shape))
    got = ts.input_specs(tcfg, tconfigs.SHAPES[shape])
    assert all(a.is_meta for a in tree_leaves(got))
    assert _spec_list(got) == [(tuple(s.shape), str(s.dtype))
                               for s in want]


def test_abstract_state_allocates_nothing():
    from repro_torch.models import params as P
    cfg = tconfigs.get_config("yi-6b")
    specs = ts.model_specs(cfg)
    state = ts.make_abstract_state(cfg)
    assert sum(a.numel() for a in tree_leaves(state["params"])) == \
        P.n_params(specs)
    assert P.bytes_of(specs) == 4 * P.n_params(specs)
    assert all(a.is_meta for a in tree_leaves(state))
