"""The port's distribution layer against the JAX package's: the sharding
rules (``tests/test_distribution.py``'s rules cases, and every
registered config's parameter and train-state specs at both production
mesh shapes, leaf for leaf), ``stage_periodic``, and the shifting-buffer
pipeline step on a (2, 2, 2) virtual CPU mesh against JAX's
``make_reference_loss_fn`` in all four boundary modes (the tolerances of
JAX's own pipeline tests: loss within 1e-4, gradients within 1e-3 of
each leaf's largest entry), the qwen2-vl-2b path (tied embeddings,
RMSNorm, M-RoPE, int8) over 4 stages and swarm-1b's shared stack over 3,
plus the port's reference against JAX's and the refusals.  JAX's ``resolve_spec`` takes any object with
``axis_names`` and ``shape``, so both packages resolve specs against the
same duck-typed production mesh in this process.  About 80 s serial on
the CPU, mostly JAX compiling its references.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config
from repro.configs import get_config as j_get_config
from repro.data import make_batch as j_make_batch
from repro.dist import pipeline as jpipe
from repro.dist.constrain import resolve_spec as j_resolve
from repro.dist.sharding import DEFAULT_RULES as J_RULES
from repro.models import params as jP
from repro.train import steps as jsteps

from repro_torch.configs import REGISTRY, get_config
from repro_torch.dist import pipeline as tpipe
from repro_torch.dist.mesh import NamedSharding
from repro_torch.dist.sharding import DEFAULT_RULES, param_shardings, \
    state_shardings
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.optim.adamw import Optimizer
from repro_torch.train.steps import _value_and_grad
from repro_torch.tree import tree_leaves, tree_map
from test_torch_train import ATTN_SCALE

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

SEQ, B, M = 32, 4, 2
LOSS_ATOL, GRAD_ATOL = 1e-4, 1e-3       # JAX's pipeline tests' bounds


class _Mesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": _Mesh({"data": 16, "model": 16}),
          "2x16x16": _Mesh({"pod": 2, "data": 16, "model": 16})}


# ------------------------------------------------------------ the rules
def test_rules_divisibility_fallback():
    """kv_heads=4 on a 16-way model axis falls back to replication."""
    spec = DEFAULT_RULES.spec_for(("embed", "kv_heads", "head_dim"),
                                  (4096, 4, 128), MESHES["16x16"])
    assert spec == ("data",)


def test_rules_no_double_axis_use():
    spec = DEFAULT_RULES.spec_for(("mlp", "embed2"), (4096, 4096),
                                  MESHES["16x16"])
    assert spec == ("model",)             # the first use wins


@pytest.mark.parametrize("name,n,want", [
    ("yi-6b", 2, True), ("xlstm-125m", 2, True),
    ("whisper-large-v3", 2, False), ("swarm-1b", 2, False),
    ("yi-6b", 7, False), ("swarm-1b-bottleneck", 3, True),
    ("qwen2-vl-2b", 4, True)])
def test_stage_periodicity(name, n, want):
    assert tpipe.stage_periodic(get_config(name), n) is want
    assert jpipe.stage_periodic(j_get_config(name), n) is want


def _port_specs(tree):
    return [repr(s.spec) for s in tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


def _jax_specs(cfg, mesh, pipeline):
    rules = J_RULES.with_rules(layers="pod", stage="pod") if pipeline \
        else J_RULES
    return jax.tree.map(lambda s: repr(tuple(rules.spec_for(
        s.axes, s.shape, mesh))), jsteps.model_specs(cfg),
        is_leaf=jP.is_spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_param_and_state_specs_equal_jax(name, mesh):
    """Every registered config: the port's ``param_shardings`` and
    ``state_shardings`` (plain and ``pipeline=True``) carry the JAX
    package's specs leaf for leaf."""
    m = MESHES[mesh]
    cfg, jcfg = get_config(name), j_get_config(name)
    want = jax.tree.leaves(_jax_specs(jcfg, m, False))
    assert _port_specs(param_shardings(cfg, m)) == want
    for pipeline in (False, True):
        jp = jax.tree.leaves(_jax_specs(jcfg, m, pipeline))
        st = state_shardings(cfg, m, pipeline=pipeline)
        assert _port_specs(st["params"]) == jp
        assert _port_specs(st["opt"]["m"]) == jp
        assert _port_specs(st["opt"]["v"]) == jp
        assert st["opt"]["count"].spec == () and st["step"].spec == ()


# ------------------------------------------------------------ the step
def _grad_opt():
    """An optimizer whose update is the gradient: the new params minus
    the old are the step's gradients."""
    return Optimizer(init=lambda p: {"z": torch.zeros(())},
                     update=lambda g, s, p: (g, s))


def _tiny(**kw):
    base = dict(boundary_compression="none", bottleneck_dim=16, maxout_k=4,
                pipeline_stages=2)
    base.update(kw)
    jcfg = tiny_dense_config(**base)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in ArchConfig.__dataclass_fields__})


def _jax_oracle(jcfg, n_stages, compress=None, mrope=False):
    """JAX's staged reference: (numpy params, batch, loss, grads), every
    ``wq`` / ``wk`` scaled by 0.3 (``test_torch_train.py``'s reason: at
    JAX's init the saturated softmax amplifies f32 rounding), and a tied
    embedding by 0.1 (at init it makes logits of +-20: a loss near 22,
    whose f32 rounding alone is 1e-4)."""
    params = jax.tree.map(np.array, jax.device_get(jP.init(
        jax.random.PRNGKey(0), jsteps.model_specs(jcfg))))
    for blk in params["blocks"]:
        for key in ("wq", "wk"):
            blk["attn"][key] = blk["attn"][key] * np.float32(ATTN_SCALE)
    if jcfg.tie_embeddings:
        params["embed"] = params["embed"] * np.float32(0.1)
    batch = {k: np.asarray(v) for k, v in
             j_make_batch(jcfg.vocab_size, SEQ, B).items()}
    if mrope:
        pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32) * 2,
                              (3, B, SEQ)).copy()
        pos[1] += 1
        batch["positions"] = pos
    ref = jpipe.make_reference_loss_fn(jcfg, n_stages, M, compress=compress)
    (loss, _), g = jax.jit(jax.value_and_grad(ref, has_aux=True))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return params, batch, float(loss), jax.device_get(g)


def _assert_grads(got, want):
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        a = np.asarray(a, np.float64)
        b = b.detach().double().numpy()
        scale = np.abs(a).max() + 1e-9
        np.testing.assert_allclose(b / scale, a / scale, atol=GRAD_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("mode", ["none", "int8", "bottleneck", "maxout"])
def test_pipeline_step_equals_jax_reference(mode):
    """The port's shifting-buffer step on a (2, 2, 2) virtual CPU mesh
    (2 stages on ``pod``, each microbatch of 2 split over ``data``,
    weights FSDP over ``data`` and stored over ``model``) computes JAX's
    staged reference: loss within 1e-4, every gradient within 1e-3 of
    its leaf's largest entry, the learned codecs' ``w_c`` / ``w_d``
    getting gradients.  The int8 case sits near its bound by nature: a
    last-bit difference between the packages can move an int8 code one
    step (with other weights drawn by the same rules, one gradient
    element of 16,384 lay 1.004e-3 from JAX's; see the 4-stage case
    below)."""
    jcfg, tcfg = _tiny(n_layers=2, boundary_compression=mode)
    host, batch, want_loss, want_g = _jax_oracle(jcfg, 2)
    params = from_numpy_tree(host, "cpu")
    opt = _grad_opt()
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = tpipe.make_pipeline_train_step(tcfg, opt, 2, M, remat=True)
    mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                           devices=[torch.device("cpu")] * 8)
    with mesh:
        out, m = step(state, {k: torch.as_tensor(v)
                              for k, v in batch.items()})
    assert abs(float(m["loss"]) - want_loss) < LOSS_ATOL
    grads = tree_map(lambda a, b: a - b, out["params"], params)
    _assert_grads(grads, want_g)
    _assert_port_reference(tcfg, 2, host, batch, want_loss, want_g)
    if mode in ("bottleneck", "maxout"):
        for g in tree_leaves(grads["boundary"]):
            assert float(g.abs().max()) > 0


def _pipe_grads(tcfg, n, params, batch, mesh, **kw):
    opt = _grad_opt()
    step = tpipe.make_pipeline_train_step(tcfg, opt, n, M, **kw)
    with mesh:
        out, m = step({"params": params, "opt": opt.init(params),
                       "step": torch.zeros((), dtype=torch.int32)},
                      {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(m["loss"]), tree_map(lambda a, b: a - b, out["params"],
                                      params)


def test_pipeline_tied_mrope_rmsnorm_over_4_stages():
    """The qwen2-vl-2b path at tiny width over 4 stages on ``pod`` 4 and
    ``data`` 2: tied embeddings (slot 0 embeds and slot 3 projects with
    one weight on two ``pod`` coordinates: its two gradients summed),
    RMSNorm, M-RoPE ``[3, B, S]`` positions — against JAX's reference;
    then on the int8 wire against the port's reference.  (Three int8
    crossings each way can turn the packages' last-bit differences into
    codes one step apart: with these weights untied, JAX's and the
    port's int8 references differ by 4.4e-3 of a leaf's largest
    gradient, while the port's pipeline and reference agree to 1.2e-6.
    The 2-stage int8 case above holds the port to JAX through one
    crossing.)"""
    jcfg, tcfg = _tiny(n_layers=4, rope="mrope", norm="rmsnorm",
                       tie_embeddings=True, pipeline_stages=0)
    host, batch, want_loss, want_g = _jax_oracle(jcfg, 4, mrope=True)
    params = from_numpy_tree(host, "cpu")
    mesh = make_debug_mesh((4, 2), ("pod", "data"),
                           devices=[torch.device("cpu")] * 8)
    loss, grads = _pipe_grads(tcfg, 4, params, batch, mesh, remat=False)
    assert abs(loss - want_loss) < LOSS_ATOL
    _assert_grads(grads, want_g)
    _assert_port_reference(tcfg, 4, host, batch, want_loss, want_g)
    ref = tpipe.make_reference_loss_fn(tcfg, 4, M, compress="int8")
    want_loss, _, want_g = _value_and_grad(
        ref, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss, grads = _pipe_grads(tcfg, 4, params, batch, mesh,
                              compress="int8")
    assert abs(loss - float(want_loss)) < LOSS_ATOL
    _assert_grads(grads, [g.numpy() for g in tree_leaves(want_g)])


def _assert_port_reference(tcfg, n, host, batch, want_loss, want_g,
                           compress=None):
    """The port's sequential staged reference against JAX's: loss within
    1e-4, gradients within 1e-3 of each leaf's largest entry."""
    ref = tpipe.make_reference_loss_fn(tcfg, n, M, compress=compress)
    loss, _, g = _value_and_grad(ref, from_numpy_tree(host, "cpu"),
                                 {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    assert abs(float(loss) - want_loss) < LOSS_ATOL
    _assert_grads(g, want_g)


def test_shared_stack_reference_and_step_equal_jax():
    """swarm-1b's structure at tiny width (3 stages of one shared layer
    applied twice, the learned bottleneck): the port's reference and its
    pipeline step over ``pod`` 3 against JAX's reference."""
    jcfg, tcfg = _tiny(n_layers=6, share_groups=3, pipeline_stages=3,
                       boundary_compression="bottleneck")
    host, batch, want_loss, want_g = _jax_oracle(jcfg, 3)
    _assert_port_reference(tcfg, 3, host, batch, want_loss, want_g)
    loss, grads = _pipe_grads(
        tcfg, 3, from_numpy_tree(host, "cpu"), batch,
        make_debug_mesh((3, 1), ("pod", "data"),
                        devices=[torch.device("cpu")] * 3))
    assert abs(loss - want_loss) < LOSS_ATOL
    _assert_grads(grads, want_g)


def test_refusals():
    """The learned codecs need ``pipeline_stages == n_stages``, a
    non-periodic stack has no shifting buffer, and a batch must split
    into the microbatches."""
    opt = _grad_opt()
    _, tcfg = _tiny(boundary_compression="bottleneck", pipeline_stages=0)
    with pytest.raises(ValueError, match="pipeline_stages"):
        tpipe.make_pipeline_train_step(tcfg, opt, 2, M)
    with pytest.raises(ValueError, match="pipeline_stages"):
        tpipe.make_reference_loss_fn(tcfg, 2, M)
    with pytest.raises(ValueError, match="not periodic"):
        tpipe.make_pipeline_train_step(get_config("swarm-1b"), opt, 2, M)
    _, tcfg = _tiny()
    step = tpipe.make_pipeline_train_step(tcfg, opt, 2, 3)
    from repro_torch.train.steps import make_state
    state = make_state(tcfg, opt, 0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        step(state, {"tokens": torch.zeros((8, SEQ), dtype=torch.int32),
                     "labels": torch.zeros((8, SEQ), dtype=torch.int32)})


# ------------------------------------------------------------ hints, inputs
def test_constrain_is_identity_off_a_mesh_and_relays_placed_tensors():
    """``constrain`` checks the rank, is the identity off a mesh, for a
    plain tensor, and where the spec resolves to replication; inside a
    mesh it lays a placed tensor out again to the resolved spec."""
    from repro_torch.dist.constrain import constrain, current_mesh
    from repro_torch.dist.mesh import gather, place
    x = torch.arange(32.).reshape(4, 8)
    with pytest.raises(ValueError, match="axis specs for rank-2"):
        constrain(x, "data")
    assert constrain(x, "data", None) is x and current_mesh() is None
    mesh = make_debug_mesh((2, 2), devices=[torch.device("cpu")] * 4)
    p = place(x, mesh, ())
    with mesh:
        assert current_mesh() is mesh
        assert constrain(x, "data", None) is x
        assert constrain(p, None, "pod") is p        # absent axis: ()
        q = constrain(p, ("pod", "data"), "model")
        assert q.spec == ("data", "model")
        assert torch.equal(gather(q, "cpu"), x)
        assert q.shards[1, 0].shape == (2, 4)
    assert current_mesh() is None


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
@pytest.mark.parametrize("name", ["yi-6b", "qwen2-vl-2b", "hymba-1.5b"])
def test_batch_and_cache_shardings_equal_jax(name, shape):
    """Input batches (the batch dim over ``("pod", "data")``, M-RoPE
    positions at dim 1) and decode caches (the param rules, ``batch`` on
    the cell's axis) resolve as the JAX package's rules do."""
    from repro.configs import SHAPES as J_SHAPES
    from repro_torch.configs import SHAPES
    from repro_torch.dist.sharding import batch_shardings, \
        cache_shardings_from_specs
    from repro_torch.train import steps as tsteps
    m = MESHES["2x16x16"]
    cfg, jcfg = get_config(name), j_get_config(name)
    if SHAPES[shape].kind == "train":
        got = batch_shardings(cfg, m, tsteps.train_batch_specs(
            cfg, SHAPES[shape]))
        jspecs = jsteps.train_batch_specs(jcfg, J_SHAPES[shape])
        for key, s in jspecs.items():
            axes = [("pod", "data")] + [None] * (len(s.shape) - 1)
            if key == "positions":
                axes = [None, ("pod", "data")] + [None] * (len(s.shape) - 2)
            assert got[key].spec == tuple(j_resolve(axes, s.shape, m)), key
        return
    got = cache_shardings_from_specs(cfg, m, tsteps.decode_cache_param_specs(
        cfg, SHAPES[shape]), batch_axis="data")
    rules = J_RULES.with_rules(batch="data")
    want = jax.tree.leaves(jax.tree.map(
        lambda s: repr(tuple(rules.spec_for(s.axes, s.shape, m))),
        jsteps.decode_cache_param_specs(jcfg, J_SHAPES[shape]),
        is_leaf=jP.is_spec))
    assert _port_specs(got) == want


def test_whisper_reference_loss_equals_jax():
    """The encoder-decoder branch of ``make_reference_loss_fn`` (the
    encoder pod, then the decoder slices, int8 crossings of the hidden
    and encoder states) gives JAX's loss on the same numpy weights and
    batch (forward only: the staged programs' gradients are held to
    JAX's in ``tests/test_torch_whisper.py``); learned codecs are
    refused there as in JAX."""
    from repro.models import whisper as JW
    from test_hetero_swarm import _whisper_batch, whisper_config
    from test_torch_families import _numpy_init, port_cfg
    jcfg = whisper_config()
    tcfg = port_cfg(jcfg)
    host = _numpy_init(JW.whisper_specs(jcfg), 0)
    for blk in ("enc_blocks", "dec_blocks"):
        for att in ("attn", "xattn"):
            if att in host[blk]:
                for key in ("wq", "wk"):
                    host[blk][att][key] = host[blk][att][key] * \
                        np.float32(ATTN_SCALE)
    batch = _whisper_batch(jcfg, 0, b=4)
    jref = jpipe.make_reference_loss_fn(jcfg, 3, 2, compress="int8")
    want = float(jax.jit(jref)(jax.tree.map(jnp.asarray, host),
                               jax.tree.map(jnp.asarray, batch))[0])
    tref = tpipe.make_reference_loss_fn(tcfg, 3, 2, compress="int8")
    with torch.no_grad():
        got = float(tref(from_numpy_tree(host, "cpu"),
                         tree_map(torch.as_tensor, batch))[0])
    assert abs(got - want) <= 1e-5 * abs(want)
    with pytest.raises(NotImplementedError, match="learned"):
        tpipe.make_reference_loss_fn(tcfg.with_overrides(
            boundary_compression="bottleneck", bottleneck_dim=16,
            pipeline_stages=3), 3, 2)
