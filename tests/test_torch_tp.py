"""Tensor-parallel compute over the mesh's ``model`` axis
(``repro_torch.dist.tensor_parallel``) for the dense attention stack
(the ``moe`` kind's expert parallelism: ``test_torch_moe_tp.py``),
against the one-device step and the JAX package, on virtual CPU meshes
(one device listed 2 or 4 times: the placement, splitting, gathering and
reduction code of distinct devices, without their copies).  Also the
dry run's two repairs: a MoE serving cell routes with the whole batch's
capacity (F4), and no gathered tensor waits for the garbage collector
(F5).

Tolerances: a ``(1, 1)`` mesh equals the numeric step to the bit (it
takes the gathered path); with ``model`` > 1, in f32, each output, the
loss, the input cotangent and every parameter gradient lies within 1e-5
of the one-device step's largest entry of that leaf (the order of the
sums); a 3-step trajectory lies within 2e-4 of JAX's sequential
reference on shared numpy inputs, JAX's ``wq`` / ``wk`` scaled by 0.3
as ``test_torch_train.py`` explains; a stage's forward and backward lie
within 1e-5 of JAX's ``MeshExecutor`` on a forced 4-device CPU mesh
``("data", "model")``; on meta, each coordinate's gathered parameter
bytes equal its blocks' reckoned bytes to the byte.
"""
import gc
import json
import os
import subprocess
import sys
import textwrap
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist import mesh as M
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import DEFAULT_RULES, stage_param_shardings
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import params as P
from repro_torch.models.blocks import TP_APPLY
from repro_torch.runtime import MeshExecutor, MeshSpanExecutor, \
    StageState, build_numeric_executors
from repro_torch.tree import tree_leaves, tree_map
from test_torch_mesh import _jax_params, _jax_reference, _runner
from test_torch_train import ATTN_SCALE, TRAJ_ATOL, _assert_exactly_once, \
    _close_rel, _configs

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

ROOT = Path(__file__).resolve().parents[1]
SEQ = 32
CPU = torch.device("cpu")
GRAD_RTOL = 1e-5
SHARED = dict(share_groups=2, boundary_compression="bottleneck",
              bottleneck_dim=16, pipeline_stages=2)


def _mesh(shape, devices=None):
    n = shape[0] * shape[1]
    return make_debug_mesh(shape, ("data", "model"),
                           devices=devices or [CPU] * n)


def _codec(tcfg):
    """The learned codec of a config, else no wire codec: the chains
    below hand boundaries from stage to stage as the span program
    does."""
    c = tcfg.boundary_compression
    return c if c in ("bottleneck", "maxout") else "none"


def _cfg(**kw):
    return _configs(**kw)[1]


def _numeric(tcfg, n_stages, seed=0):
    """Numeric executors and their states, every ``wq`` / ``wk`` scaled
    by ATTN_SCALE (``test_torch_train.py``)."""
    num = build_numeric_executors(tcfg, n_stages, SEQ,
                                  compress=_codec(tcfg), device="cpu")
    sts = []
    for s, ex in enumerate(num):
        st = ex.init_state(seed + s)
        with torch.no_grad():
            for seg in st.params["blocks"]:
                for key in ("wq", "wk"):
                    seg["attn"][key].mul_(ATTN_SCALE)
        sts.append(st)
    return num, sts


def _inputs(tcfg, rows=2, seed=5):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, tcfg.vocab_size, (rows, SEQ), generator=g)
    lab = torch.randint(0, tcfg.vocab_size, (rows, SEQ), generator=g)
    return tok, lab, g


def _mesh_exec(tcfg, n_stages, where, mesh):
    if isinstance(where, tuple):
        return MeshSpanExecutor(tcfg, n_stages, SEQ, where, mesh,
                                compress=_codec(tcfg))
    return MeshExecutor(tcfg, n_stages, SEQ, where, mesh,
                        compress=_codec(tcfg))


def _restored(ex, num, sts):
    st = StageState()
    if isinstance(ex, MeshSpanExecutor):
        ex.restore(st, {"per_stage": {s: num[s].snapshot(sts[s])
                                      for s in ex.stages}})
    else:
        ex.restore(st, num[ex.stage].snapshot(sts[ex.stage]))
    return st


def _run_pair(tcfg, n_stages, where, mesh):
    """The mesh executor's forward and backward of ``where`` (a stage or
    a span ``(lo, hi)``) on one microbatch, and the numeric chain's:
    ``(executor, got, want)``, lists of tensors (the output or the loss,
    the input cotangent past stage 0, every gradient leaf)."""
    num, sts = _numeric(tcfg, n_stages)
    ex = _mesh_exec(tcfg, n_stages, where, mesh)
    st = _restored(ex, num, sts)
    tok, lab, g = _inputs(tcfg)
    lo, hi = (where, where + 1) if isinstance(where, int) else where
    last = hi == n_stages
    xs = [tok]                         # the chain's inputs, lo .. hi
    for s in range(hi):
        if s == lo:
            xs = [xs[-1]]
        xs.append(num[s].run_fwd(sts[s], xs[-1], lab if s == n_stages - 1
                                 else None))
    x = xs[0]
    dy = None if last else torch.randn(xs[-1].shape, generator=g)
    got = [ex.run_fwd(st, x, lab if last else None).reshape(-1)]
    want = [xs[-1].reshape(-1)]
    loss, gx, gp = ex.run_bwd(st, x, dy=dy, labels=lab if last else None)
    grads, d = {}, dy
    for k in reversed(range(hi - lo)):
        s = lo + k
        if s == n_stages - 1:
            ref_loss, d, grads[s] = num[s].run_bwd(sts[s], xs[k],
                                                   labels=lab)
            got.append(loss.reshape(1))
            want.append(ref_loss.reshape(1))
        else:
            _, d, grads[s] = num[s].run_bwd(sts[s], xs[k], dy=d)
    if lo > 0:
        got.append(gx)
        want.append(d)
    flat = ([a for s in sorted(gp) for a in tree_leaves(gp[s])]
            if isinstance(gp, dict) and "blocks" not in gp
            else tree_leaves(gp))
    got += [M.gather(a, CPU) for a in flat]
    want += [a for s in range(lo, hi) for a in tree_leaves(grads[s])]
    assert len(got) == len(want)
    return ex, got, want


# ------------------------------------------------------------------ plan
class _DuckMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch,m,want", [
    ("yi-6b", 16, dict(wq=2, wk=None, wo_mlp=0, vocab=0)),
    ("gemma-2b", 16, dict(wq=None, wk=None, wo_mlp=0, vocab=0)),
    ("qwen1.5-4b", 16, dict(wq=None, wk=None, wo_mlp=0, vocab=0)),
    ("qwen2-vl-2b", 16, dict(wq=None, wk=None, wo_mlp=0, vocab=0)),
    ("swarm-1b-bottleneck", 2, dict(wq=2, wk=2, wo_mlp=0, vocab=None)),
])
def test_plan_reads_the_resolved_specs(arch, m, want):
    """Which leaves split over ``model`` follows each leaf's resolved
    spec (the divisibility fallback), as the production mesh resolves
    the four dense cells and the card's swarm-1b check: the heads split
    where they divide, kv heads replicate where they do not, the FFN
    splits, the vocab splits but for swarm-1b's odd 50,257."""
    from repro_torch.configs import get_config
    from repro_torch.train.steps import model_specs
    cfg = get_config(arch)
    mesh = _DuckMesh({"data": 16, "model": m})
    specs = model_specs(cfg)
    blk = specs["blocks"][0]

    def dim(spec):
        return tp.split_dim(DEFAULT_RULES.sharding_for(spec, mesh))
    assert dim(blk["attn"]["wq"]) == want["wq"]
    assert dim(blk["attn"]["wk"]) == want["wk"]
    assert dim(blk["mlp"]["wo"]) == 1 + want["wo_mlp"]    # under "layers"
    assert dim(specs["embed"]) == want["vocab"]
    assert tp.runs_tensor_parallel(cfg, set(cfg.block_kinds),
                                   _DuckMesh({"data": 16, "model": m}))


def test_supported_kinds_and_paths():
    """The dense ``attn`` kind, llama4-scout's ``moe`` and deepseek-v2's
    ``mla`` / ``mla_moe`` compute tensor-parallel; whisper and a mesh
    without a second model shard keep the gathered path, and each
    executor says which path it runs."""
    from repro_torch.configs import get_config
    assert set(TP_APPLY) == set(tp.SUPPORTED_KINDS) == {"attn", "moe",
                                                        "mla", "mla_moe"}
    tcfg = _cfg()
    assert MeshExecutor(tcfg, 2, SEQ, 1, _mesh((1, 2))).compute_path == \
        "tensor_parallel"
    assert MeshExecutor(tcfg, 2, SEQ, 1, _mesh((2, 1))).compute_path == \
        "gathered"
    moe = get_config("llama4-scout-17b-a16e")
    mla = get_config("deepseek-v2-236b")
    whisper = get_config("whisper-large-v3")
    duck = _DuckMesh({"data": 2, "model": 2})
    assert tp.runs_tensor_parallel(moe, set(moe.block_kinds), duck)
    assert not tp.runs_tensor_parallel(
        moe, set(moe.block_kinds), _DuckMesh({"data": 4, "model": 1}))
    assert tp.runs_tensor_parallel(mla, set(mla.block_kinds), duck)
    assert not tp.runs_tensor_parallel(
        mla, set(mla.block_kinds), _DuckMesh({"data": 4, "model": 1}))
    assert not tp.runs_tensor_parallel(whisper, {"attn"}, duck)


# -------------------------------------------------------------- gathers
def test_gather_block_on_every_leaf_kind():
    """``gather_block`` gives model shard ``j`` block ``j`` of a leaf
    split over ``model`` (on any dim, with or without ``data``), any
    other leaf whole, the codec whole at ``j == 0`` and None elsewhere;
    each equal to the slice of the placed tensor."""
    mesh = _mesh((2, 2))
    g = torch.Generator().manual_seed(0)
    full = {"a": torch.randn(8, 6, generator=g),       # (data, model)
            "b": torch.randn(6, 8, generator=g),       # (model, data)
            "c": torch.randn(4, 6, 2, generator=g),    # (None, model)
            "d": torch.randn(8, generator=g),          # (data,)
            "e": torch.randn(3, generator=g),          # replicated
            "boundary": {"w_c": torch.randn(8, 4, generator=g)}}
    specs = {"a": ("data", "model"), "b": ("model", "data"),
             "c": (None, "model"), "d": ("data",), "e": (),
             "boundary": {"w_c": ("data", "model")}}
    placed = tree_map(lambda x, s: M.place(x, mesh, s), full, specs,
                      is_leaf=lambda x: isinstance(x, tuple))
    for j in range(2):
        got = tp.gather_block(placed, CPU, j)
        torch.testing.assert_close(got["a"], full["a"][:, 3 * j:3 * j + 3],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got["b"], full["b"][3 * j:3 * j + 3],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got["c"], full["c"][:, 3 * j:3 * j + 3],
                                   rtol=0, atol=0)
        for k in "de":
            torch.testing.assert_close(got[k], full[k], rtol=0, atol=0)
        if j == 0:
            torch.testing.assert_close(got["boundary"]["w_c"],
                                       full["boundary"]["w_c"], rtol=0,
                                       atol=0)
        else:
            assert got["boundary"] is None


def test_reduce_scatter_of_blocks_equals_full_shape_parts():
    """Per-model-block gradient parts reduce-scatter into the same
    shards, to the bit, as the full-shape parts that hold each block in
    place and zeros elsewhere (a replicated leaf's part is whole; a
    part may hold None for a leaf)."""
    mesh = _mesh((2, 2))
    g = torch.Generator().manual_seed(1)
    sh = {"w": M.NamedSharding(mesh, ("data", "model")),
          "n": M.NamedSharding(mesh, ("data",))}
    shapes = {"w": torch.Size((4, 6)), "n": torch.Size((4,))}
    blocks, fulls, wheres, sources = [], [], [], []
    for i in range(2):
        for j in range(2):
            w = torch.randn(4, 3, generator=g)
            n = torch.randn(4, generator=g) if j == 0 else None
            blocks.append({"w": w, "n": n})
            fw = torch.zeros(4, 6)
            fw[:, 3 * j:3 * j + 3] = w
            fulls.append({"w": fw, "n": n if n is not None
                          else torch.zeros(4)})
            wheres.append({"model": j})
            sources.append(mesh.coord(data=i, model=j))
    got = M.reduce_scatter_tree(iter(blocks), sh, sources=sources,
                                wheres=wheres, shapes=shapes)
    want = M.reduce_scatter_tree(fulls, sh, sources=sources)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        for c in mesh.coords():
            torch.testing.assert_close(a.shards[c], b.shards[c], rtol=0,
                                       atol=0)


# ---------------------------------------------- against the one-device step
TP_CASES = [
    ("heads-split-kv-replicated-1x4", {}, (1, 4), 1),
    ("heads-replicated-mlp-split", dict(n_heads=3, n_kv_heads=1), (1, 2), 1),
    ("qkv-bias-2x2", dict(qkv_bias=True), (2, 2), 1),
    ("vocab-not-dividing", dict(vocab_size=255), (1, 2), 1),
    ("geglu-stage0-1x2", dict(act="geglu"), (1, 2), 0),
    ("swiglu-stage0-2x2", dict(act="swiglu"), (2, 2), 0),
    ("shared-layers-bottleneck", SHARED, (1, 2), 1),
    ("shared-layers-bottleneck-stage0", SHARED, (2, 2), 0),
    ("span-2x2", {}, (2, 2), (0, 2)),
    ("span-shared-1x2", SHARED, (1, 2), (0, 2)),
]


@pytest.mark.parametrize("name,kw,shape,where", TP_CASES,
                         ids=[c[0] for c in TP_CASES])
def test_tensor_parallel_stage_matches_one_device(name, kw, shape, where):
    """A mesh peer computing tensor-parallel over ``model`` equals the
    numeric chain of one device: the output (or the loss), the input
    cotangent and every gradient within 1e-5 of each leaf's largest
    entry, the gradients reduce-scattered into the params' layout."""
    tcfg = _cfg(**kw)
    ex, got, want = _run_pair(tcfg, 2, where, _mesh(shape))
    assert ex.compute_path == "tensor_parallel"
    for a, b in zip(got, want):
        _close_rel(a.detach().double().numpy(), b.detach().double().numpy(),
                   GRAD_RTOL)


def test_tied_vocab_split_single_stage_and_whole_model():
    """A tied embedding with the vocab split: a one-stage mesh peer (the
    table is embedding and head) and the whole-model step of the dry run
    (``train.steps.make_grad_fn`` over model shards, ``scale_embed``)
    equal the one-device programs within 1e-5 of each leaf's largest
    entry."""
    from repro_torch.train import steps as S
    tcfg = _cfg(tie_embeddings=True, scale_embed=True, act="geglu")
    _, got, want = _run_pair(tcfg, 1, 0, _mesh((1, 2)))
    for a, b in zip(got, want):
        _close_rel(a.double().numpy(), b.double().numpy(), GRAD_RTOL)
    specs = S.model_specs(tcfg)
    params = P.init(3, specs, "cpu")
    with torch.no_grad():
        for seg in params["blocks"]:
            for key in ("wq", "wk"):
                seg["attn"][key].mul_(ATTN_SCALE)
    mesh = _mesh((1, 2))
    sh = stage_param_shardings(specs, mesh)
    placed = tree_map(M.place_as, params, sh)
    group = tp.Group.of(mesh, data=0)
    trees = [tp.gather_block(placed, CPU, j) for j in range(2)]
    assert trees[0]["embed"].shape[0] == tcfg.vocab_size // 2
    tok, lab, _ = _inputs(tcfg)
    batch = {"tokens": tok, "labels": lab}
    for accum in (1, 2):
        l1, c1, g1 = S.make_grad_fn(tcfg, "block", accum)(params, batch)
        l2, c2, g2 = S.make_grad_fn(tcfg, "block", accum,
                                    group=group)(trees, batch)
        assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
        gp = M.reduce_scatter_tree(
            iter(g2), sh, wheres=[{"model": 0}, {"model": 1}],
            shapes=tree_map(lambda a: a.shape, params))
        for a, b in zip(tree_leaves(gp), tree_leaves(g1)):
            _close_rel(M.gather(a, CPU).numpy(), b.double().numpy(),
                       GRAD_RTOL)


def test_one_by_one_mesh_equals_numeric_to_the_bit():
    """A ``(1, 1)`` ``("data", "model")`` mesh takes the gathered path:
    forward, loss, cotangent and gradients equal the numeric step to
    the bit."""
    tcfg = _cfg()
    ex, got, want = _run_pair(tcfg, 2, 1, _mesh((1, 1)))
    assert ex.compute_path == "gathered"
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b.double(), rtol=0, atol=0)


def test_all_reduces_a_layer_and_collectives_logged():
    """Two activation all-reduces a layer application forward (the
    attention's and the FFN's), two cotangent all-reduces a layer
    backward, each logged as an ``all-reduce`` received by every model
    coordinate of the data shard."""
    tcfg = _cfg()
    num, sts = _numeric(tcfg, 2)
    ex = MeshExecutor(tcfg, 2, SEQ, 1, _mesh((1, 2)))
    st = _restored(ex, num, sts)
    tok, lab, _ = _inputs(tcfg)
    x = num[0].run_fwd(sts[0], tok)
    layers = tcfg.n_layers // 2
    tp.ALL_REDUCES.clear()
    with M.record_collectives() as rec:
        ex.run_fwd(st, x, lab)
    assert tp.ALL_REDUCES["activation"] == 2 * layers
    assert tp.ALL_REDUCES["loss"] == 3
    tp.ALL_REDUCES.clear()
    ex.run_bwd(st, x, labels=lab)
    assert tp.ALL_REDUCES["activation"] == 2 * layers     # the recompute
    assert tp.ALL_REDUCES["cotangent"] == 2 * layers + 1  # + the head's
    assert rec.counts[(0, 0)]["all-reduce"] == \
        rec.counts[(0, 1)]["all-reduce"] == 2 * layers + 3


# ----------------------------------------------------- against JAX itself
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tensor_parallel_trajectory_equals_jax_reference(shape, monkeypatch):
    """Mesh peers computing tensor-parallel at both stages beside
    numeric peers, a mesh span peer on [0, 2) too: a 3-step trajectory
    within 2e-4 of JAX's sequential reference, exactly once."""
    jcfg, tcfg = _configs()
    jprogs, jp = _jax_params(jcfg, "none")
    want = _jax_reference(jcfg, jprogs, jp, 2, 8, monkeypatch)
    r = _runner(tcfg, jp, "none", 2, 8)
    r.build(peers_per_stage=1)
    mesh = _mesh(shape)
    for s in range(2):
        ex = MeshExecutor(tcfg, 2, SEQ, s, mesh, compress="none")
        assert ex.compute_path == "tensor_parallel"
        r.add_peer(s, executor=ex)
    r.add_peer(range(0, 2), executor=MeshSpanExecutor(
        tcfg, 2, SEQ, (0, 2), mesh, compress="none"))
    m = r.run(until=1e6)
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)
    _assert_exactly_once(r, 2, 4)


_JAX_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src"); sys.path.insert(0, "tests")
    import jax, numpy as np
    from conftest import tiny_dense_config
    from repro.launch.mesh import make_debug_mesh
    from repro.runtime import MeshExecutor, build_numeric_executors
    d = np.load(sys.argv[1], allow_pickle=True).item()
    cfg = tiny_dense_config()
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    num = build_numeric_executors(cfg, 2, 32)
    st = num[1].init_state(jax.random.PRNGKey(0))
    num[1].restore(st, {"params": d["params"], "opt": None})
    mex = MeshExecutor(cfg, 2, 32, 1, mesh)
    sm = mex.init_state(jax.random.PRNGKey(9))
    mex.restore(sm, num[1].snapshot(st))
    loss, gx, gp = mex.run_bwd(sm, d["x"], labels=d["labels"])
    out = {"loss": np.asarray(loss), "gx": np.asarray(gx),
           "gp": [np.asarray(a) for a in jax.tree.leaves(gp)],
           "fwd": np.asarray(mex.run_fwd(sm, d["x"], d["labels"]))}
    np.save(sys.argv[2], out, allow_pickle=True)
""")


def test_stage_matches_jax_mesh_executor(tmp_path):
    """The last stage's forward and backward on a 2 x 2 ``("data",
    "model")`` mesh: the port's tensor-parallel mesh peer (a virtual CPU
    mesh) against JAX's ``MeshExecutor`` on 4 forced CPU devices (GSPMD
    over the same layout), on shared numpy params and inputs: loss,
    input cotangent and every gradient within 1e-5 of each leaf's
    largest entry."""
    from test_torch_families import _numpy_init
    jcfg, tcfg = _configs()
    import repro.runtime as jrt
    jprogs = jrt.build_stage_programs(jcfg, 2, SEQ)
    params = _numpy_init(jprogs[1].specs, 1)
    for blk in params["blocks"]:
        for key in ("wq", "wk"):
            blk["attn"][key] = blk["attn"][key] * np.float32(ATTN_SCALE)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, SEQ, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, SEQ)).astype(np.int32)
    np.save(tmp_path / "in.npy", {"params": params, "x": x,
                                  "labels": labels}, allow_pickle=True)
    r = subprocess.run([sys.executable, "-c", _JAX_MESH,
                        str(tmp_path / "in.npy"), str(tmp_path / "out.npy")],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "out.npy", allow_pickle=True).item()
    mex = MeshExecutor(tcfg, 2, SEQ, 1, _mesh((2, 2)))
    assert mex.compute_path == "tensor_parallel"
    st = StageState()
    mex.restore(st, {"params": params, "opt": None})
    xt, lt = torch.as_tensor(x), torch.as_tensor(labels)
    loss, gx, gp = mex.run_bwd(st, xt, labels=lt)
    _close_rel([float(loss), float(mex.run_fwd(st, xt, lt))],
               [float(want["loss"]), float(want["fwd"])], GRAD_RTOL)
    _close_rel(gx.numpy(), want["gx"], GRAD_RTOL)
    got = [M.gather(a, CPU).numpy() for a in tree_leaves(gp)]
    assert len(got) == len(want["gp"])
    for a, b in zip(got, want["gp"]):
        _close_rel(a, b, GRAD_RTOL)


# ----------------------------------------------------------- bytes on meta
@pytest.mark.parametrize("arch,shape,stage", [
    ("yi-6b", (2, 8), 1), ("yi-6b", (2, 8), 0),
    ("swarm-1b-bottleneck", (2, 2), 1), ("gemma-2b", (1, 16), 0),
    ("llama4-scout-17b-a16e", (2, 8), 1), ("deepseek-v2-236b", (2, 8), 1)])
def test_meta_gathered_bytes_equal_the_blocks(arch, shape, stage):
    """On a meta mesh at full width, every coordinate's gathered params
    (``MeshExecutor``'s model blocks) hold exactly the bytes
    ``block_bytes`` reckons from the specs and the plan, to the byte;
    model shard ``j > 0`` holds no codec."""
    from repro_torch.configs import get_config
    from repro_torch.launch import hlo_analysis as H
    cfg = get_config(arch)
    cfg = cfg.with_overrides(n_layers=3, block_pattern=(
        cfg.block_pattern[:3] if cfg.block_pattern else None))
    meta = torch.device("meta")
    mesh = _mesh(shape, [meta] * (shape[0] * shape[1]))
    ex = MeshExecutor(cfg, 3, SEQ, stage, mesh)
    assert ex.compute_path == "tensor_parallel"
    st = StageState(params=ex._place(P.abstract(ex.prog.specs),
                                     ex.param_shardings))
    for i in range(shape[0]):
        with H.DeviceLedger() as led:
            ms = ex._model_shards(st, i)
        for j, (tree, c) in enumerate(zip(ms.trees, ms.group.coords)):
            got = sum(a.numel() * a.element_size()
                      for a in tree_leaves(tree))
            assert got == tp.block_bytes(ex.prog.specs, ex.param_shardings,
                                         j)
            assert led.live[c] >= 0
        if "boundary" in ex.prog.specs:
            assert ms.trees[1]["boundary"] is None


# ---------------------------------------------------- the dry run's cells
def test_dryrun_train_cell_computes_tensor_parallel(monkeypatch):
    """A dense ``train_4k`` cell on the production mesh computes over
    data shard 0's 16 model coordinates: the busiest coordinate's peak
    drops below the gathered path's (the parent's scheme, forced here
    by a mesh-free model axis), and each computing coordinate receives
    all-reduces.  Depth cut to one layer."""
    from repro_torch.launch import dryrun
    full = dryrun.get_config("gemma-2b").with_overrides(n_layers=1)
    monkeypatch.setattr(dryrun, "get_config", lambda a: full)
    rec = dryrun.run_cell("gemma-2b", "train_4k", "single", skip_probe=True)
    assert rec["status"] == "ok"
    assert rec["collectives"]["counts"]["all-reduce"] > 3
    monkeypatch.setattr(dryrun, "_tensor_parallel", lambda *a: False)
    base = dryrun.run_cell("gemma-2b", "train_4k", "single",
                           skip_probe=True)
    assert rec["memory"]["peak_per_device"] < \
        base["memory"]["peak_per_device"] / 4


def test_reduce_scatter_blocks_alike_equals_folding_every_part():
    """The dry run's tensor-parallel fold of equal data shards' model
    block parts (the data shards past the second replayed) records what
    folding every part records: bytes a coordinate, peak, moves."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as H
    meta = torch.device("meta")
    mesh = _mesh((4, 2), [meta] * 8)
    grads = [{"a": torch.empty(64, 16, device=meta),
              "b": torch.empty(8, device=meta)} for _ in range(2)]
    shardings = {"a": M.NamedSharding(mesh, ("data", "model")),
                 "b": M.NamedSharding(mesh, ())}
    shapes = {"a": torch.Size((64, 32)), "b": torch.Size((8,))}
    groups = [tp.Group.of(mesh, data=i) for i in range(4)]

    def record(fold):
        with M.record_collectives() as rec, H.DeviceLedger() as led:
            gp = fold()
        return ({c: led.total_bytes(c) for c in mesh.coords()},
                dict(led.peak), rec.bytes, rec.counts,
                [tuple(p.shards[c].shape for c in mesh.coords())
                 for p in tree_leaves(gp)])

    fast = record(lambda: dryrun._reduce_scatter_blocks_alike(
        grads, shardings, groups, shapes))
    slow = record(lambda: M.reduce_scatter_tree(
        (g for _ in groups for g in grads), shardings,
        sources=[c for g in groups for c in g.coords],
        wheres=[{"model": j} for _ in groups for j in range(2)],
        shapes=shapes))
    assert fast == slow


# ------------------------------------------------------------ F4 and F5
def test_moe_prefill_cell_routes_with_the_whole_batch_capacity(monkeypatch):
    """F4: a tiny MoE config's ``prefill_32k`` cell on a (2, 1) meta mesh
    computes data shard 0 for both: each MoE layer routes with the
    token count that sets the capacity of ``apply_moe`` on the unsplit
    batch (run on the CPU), not the shard's own: read from the split
    context each ``apply_moe`` call routes under."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as L
    base = get_config("llama4-scout-17b-a16e")
    cfg = base.with_overrides(n_layers=1, d_model=64, n_heads=2,
                              n_kv_heads=1, head_dim=64, vocab_size=128,
                              d_ff=64, block_pattern=None,
                              moe=base.moe.__class__(**{
                                  **base.moe.__dict__, "d_ff_expert": 32,
                                  "num_experts": 4}))
    shape = SHAPES["prefill_32k"].__class__(**{
        **SHAPES["prefill_32k"].__dict__, "global_batch": 2,
        "seq_len": 64})
    seen = []
    orig = L.apply_moe

    def spy(cfg_, p, x, route=None):
        prov = L.split_provider()
        T = x.shape[0] * x.shape[1]
        seen.append(T if prov is None else
                    prov(T, torch.zeros(cfg.moe.num_experts,
                                        dtype=torch.int64)).tokens)
        return orig(cfg_, p, x, route)
    monkeypatch.setattr(L, "apply_moe", spy)
    meta = torch.device("meta")
    mesh = make_debug_mesh((2, 1), ("data", "model"), devices=[meta] * 2)
    cell = dryrun.build_cell(cfg, shape, mesh)
    cell.run()
    split = set(seen)
    # apply_moe on the unsplit batch, on the CPU
    seen.clear()
    L.apply_moe(cfg, P.init(0, L.moe_specs(cfg), "cpu"),
                torch.randn(2, 64, cfg.d_model))
    assert split == set(seen) == {2 * 64}


def test_gathered_tensor_dies_by_refcount():
    """F5: with the garbage collector off, a gathered tensor (several
    blocks joined) and the leaves ``tree_leaves`` returned are freed as
    soon as they are dropped: no reference cycle holds them."""
    from repro_torch.tree import tree_unflatten_like
    mesh = _mesh((2, 2))
    p = M.place(torch.randn(8, 6), mesh, ("data", "model"))
    was = gc.isenabled()
    gc.disable()
    try:
        t = M.gather(p, CPU)
        ref = weakref.ref(t)
        del t
        assert ref() is None
        leaves = tree_leaves({"a": [torch.randn(3)], "b": torch.randn(2)})
        refs = [weakref.ref(a) for a in leaves]
        rebuilt = tree_unflatten_like({"a": [0], "b": 0}, leaves)
        del leaves, rebuilt
        assert all(r() is None for r in refs)
        blk = tp.gather_block({"w": p}, CPU, 1)["w"]
        ref = weakref.ref(blk)
        del blk
        assert ref() is None
    finally:
        if was:
            gc.enable()


_GC_CELL = textwrap.dedent("""
    import gc, json, sys
    sys.path.insert(0, "src")
    if sys.argv[2] == "off":
        gc.disable()
    from repro_torch.launch import dryrun as d
    if sys.argv[3] == "gathered":
        d._tensor_parallel = lambda *a: False
    full = d.get_config(sys.argv[1])
    d.get_config = lambda a: full.with_overrides(n_layers=1)
    rec = d.run_cell(sys.argv[1], "train_4k", "single", skip_probe=True)
    print(json.dumps(rec["memory"]))
""")


@pytest.mark.parametrize("arch,path", [
    ("llama4-scout-17b-a16e", "gathered"), ("gemma-2b", "tensor-parallel"),
    ("llama4-scout-17b-a16e", "expert-parallel")],
    ids=["gathered", "tensor-parallel", "expert-parallel"])
def test_dryrun_peak_does_not_follow_the_collector(arch, path):
    """F5: a one-layer ``train_4k`` cell (llama4-scout on the gathered
    path, gemma-2b tensor-parallel, llama4-scout expert-parallel)
    reckons the same memory, to the byte, with the garbage collector off
    as with it on (each in a fresh process)."""
    out = {}
    for mode in ("on", "off"):
        r = subprocess.run([sys.executable, "-c", _GC_CELL, arch, mode,
                            path],
                           capture_output=True, text=True, cwd=ROOT,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        out[mode] = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["on"] == out["off"]
