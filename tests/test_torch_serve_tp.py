"""Tensor-parallel serving over the mesh's ``model`` axis: prefill with
cache emission and the one-token decode of the ``attn``, ``moe``,
``mla`` and ``mla_moe`` kinds over a data shard's model shards
(``models.blocks.TP_PREFILL`` / ``TP_DECODE``,
``models.model.lm_prefill_tp`` / ``lm_decode_step_tp``,
``train.steps.make_prefill_step`` / ``make_serve_step`` with a group),
the vocab-parallel greedy argmax, and the dry run's serving cells, on
virtual CPU meshes (one device listed 2-4 times) at reduced sizes
(``get_reduced``: 4 heads, 2 kv heads, head dim 16, d 64).

Tolerances: over 2 and 4 model shards, in f32, each step's logits lie
within 1e-5 of the one-device step's largest entry and its greedy
tokens are equal; every cache block lies within 1e-5 of its part of the
one-device cache, and the copies of a replicated cache (kv heads that do
not divide ``model``, MLA's latent cache) are equal to the bit after
the prefill and after every decode step.  Over 3 model shards (4 heads
do not divide) every step equals the one-device step to the bit.  Over
2 data x 2 model shards the steps lie within 1e-5 of JAX's
``make_prefill_step`` / ``make_serve_step`` (caches; tokens equal), and
each MoE pair's expert, slot and kept flag are those of the whole
batch's routing of the same router inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import model as jmodel
from repro.train import steps as jsteps

from repro_torch.dist import mesh as M
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import stage_param_shardings
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as model_lib
from repro_torch.models import params as P
from repro_torch.models.params import from_numpy_tree
from repro_torch.train import steps as S
from repro_torch.tree import tree_leaves, tree_map
from test_torch_families import _numpy_init, port_cfg

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

CPU = torch.device("cpu")
TOL = 1e-5
PROMPT, NEW = 16, 8
# name -> (arch, block kind, MLA q_lora rank): GQA (4 heads over 2 kv
# heads: the cache splits over 2 model shards, 4 hold a copy each), the
# windowed ring (danube's 8 slots, passed by the prompt and the decode
# steps), routed experts, and latent attention with and without q_lora
CASES = {
    "attn": ("yi-6b", None, None),
    "attn_window": ("h2o-danube-3-4b", None, None),
    "moe": ("llama4-scout-17b-a16e", None, None),
    "mla": ("deepseek-v2-236b", "mla", 0),
    "mla_q_lora": ("deepseek-v2-236b", "mla", 24),
    "mla_moe": ("deepseek-v2-236b", "mla_moe", 0),
    "mla_moe_q_lora": ("deepseek-v2-236b", "mla_moe", 24),
}


def _configs(name):
    arch, kind, q_lora = CASES[name]
    jcfg = j_get_reduced(arch)
    if kind is not None:
        jcfg = dataclasses.replace(
            jcfg, block_pattern=(kind,) * jcfg.n_layers,
            mla=dataclasses.replace(jcfg.mla, q_lora_rank=q_lora))
    return jcfg, port_cfg(jcfg)


def _mesh(shape):
    return make_debug_mesh(shape, ("data", "model"),
                           devices=[CPU] * (shape[0] * shape[1]))


def _blocks(params, tcfg, mesh, data=0):
    """Data shard ``data``'s model shards' blocks of ``params``, placed by
    the rules."""
    specs = S.model_specs(tcfg)
    placed = tree_map(M.place_as, params, stage_param_shardings(specs,
                                                               mesh))
    return [tp.gather_block(placed, CPU, j)
            for j in range(mesh.shape["model"])]


def _tokens(tcfg, rows=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, tcfg.vocab_size, (rows, PROMPT), generator=g)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _check_caches(one, shards, exact=False):
    """Every model shard's caches against the one-device caches: a leaf
    of the whole shape (a copy) within TOL, and equal to the bit across
    the shards; a block within TOL of its part (the kv heads dim)."""
    want = tree_leaves(one)
    got = [tree_leaves(c) for c in shards]
    for i, a in enumerate(want):
        leaves = [g[i] for g in got]
        if leaves[0].shape == a.shape:
            for b in leaves[1:]:
                assert torch.equal(b, leaves[0])      # the copies
            blocks = [a] * len(leaves)
        else:
            d = next(k for k, (x, y) in enumerate(zip(leaves[0].shape,
                                                     a.shape)) if x != y)
            blocks = a.chunk(len(leaves), d)
        for b, w in zip(leaves, blocks):
            if exact:
                assert torch.equal(b, w)
            else:
                assert _rel(b, w) <= TOL


def _serve_both(tcfg, params, mesh_shape, tokens):
    """The one-device prefill and NEW decode steps, and those over the
    ``(1, m)`` mesh's model shards, step by step: yields ``(one logits,
    tp logits joined, one caches, tp caches a model shard, one tokens,
    tp tokens)``."""
    mesh = _mesh(mesh_shape)
    group = tp.Group.of(mesh, data=0)
    trees = _blocks(params, tcfg, mesh)
    L_c = PROMPT + NEW
    l1, c1 = model_lib.lm_prefill(tcfg, params, tokens, cache_len=L_c)
    lp, cp = model_lib.lm_prefill_tp(tcfg, [trees], [group], [tokens],
                                     cache_len=L_c)
    t1 = l1[:, -1:].argmax(-1)
    t2 = tp.vocab_parallel_argmax(lp[0], group)
    yield l1, torch.cat(lp[0], -1), c1, cp[0], t1, t2
    for i in range(NEW):
        l1, c1 = model_lib.lm_decode_step(tcfg, params, t1, c1, PROMPT + i)
        lp, cp = model_lib.lm_decode_step_tp(tcfg, [trees], [group], [t2],
                                             cp, PROMPT + i)
        t1 = l1.argmax(-1)
        t2 = tp.vocab_parallel_argmax(lp[0], group)
        yield l1, torch.cat(lp[0], -1), c1, cp[0], t1, t2


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_serving_over_model_shards_equals_one_device(name, m):
    """Prefill, then NEW decode steps, over ``m`` model shards against
    the one-device steps on the same weights: logits within TOL of the
    largest entry, tokens equal, each cache block within TOL of its part
    and the copies of a replicated cache equal to the bit after every
    step; the activations cross as all-reduces (one a split half a
    layer), the greedy token as an argmax gather."""
    _, tcfg = _configs(name)
    params = P.init(3, S.model_specs(tcfg), "cpu")
    tp.ALL_REDUCES.clear()
    for l1, l2, c1, c2, t1, t2 in _serve_both(tcfg, params, (1, m),
                                              _tokens(tcfg)):
        assert _rel(l2, l1) <= TOL
        assert torch.equal(t1, t2)
        _check_caches(c1, c2)
    assert tp.ALL_REDUCES["activation"] > 0
    assert tp.ALL_REDUCES["argmax"] == NEW + 1


@pytest.mark.parametrize("name", ["attn", "attn_window", "moe", "mla",
                                  "mla_moe_q_lora"])
def test_heads_not_dividing_model_serve_equal_to_the_bit(name):
    """Over 3 model shards nothing of the reduced configs splits (4
    heads, 512 vocab rows, 128 FFN columns, 4 experts): every mixer runs
    whole at home, the other shards write their copies of the caches,
    and every step equals the one-device step to the bit, with no
    collective."""
    _, tcfg = _configs(name)
    params = P.init(4, S.model_specs(tcfg), "cpu")
    tp.ALL_REDUCES.clear()
    for l1, l2, c1, c2, t1, t2 in _serve_both(tcfg, params, (1, 3),
                                              _tokens(tcfg, seed=2)):
        assert torch.equal(l1, l2) and torch.equal(t1, t2)
        _check_caches(c1, c2, exact=True)
    assert not tp.ALL_REDUCES


def test_serving_steps_take_a_group():
    """``make_prefill_step`` / ``make_serve_step`` with a group give the
    model functions' tokens and caches; a kind outside
    ``SUPPORTED_KINDS`` (xlstm) is refused, not gathered."""
    _, tcfg = _configs("mla_moe_q_lora")
    params = P.init(5, S.model_specs(tcfg), "cpu")
    mesh = _mesh((1, 2))
    group = tp.Group.of(mesh, data=0)
    trees = _blocks(params, tcfg, mesh)
    tok = _tokens(tcfg)
    L_c = PROMPT + 2
    n1, c1 = S.make_prefill_step(tcfg, cache_len=L_c)(params,
                                                      {"tokens": tok})
    n2, c2 = S.make_prefill_step(tcfg, cache_len=L_c, group=group)(
        trees, {"tokens": tok})
    assert n2.dtype == torch.int32 and torch.equal(n1, n2)
    _check_caches(c1, c2)
    for pos in (PROMPT, PROMPT + 1):
        n1, c1 = S.make_serve_step(tcfg)(params, c1, n1, pos)
        n2, c2 = S.make_serve_step(tcfg, group=group)(trees, c2, n2, pos)
        assert torch.equal(n1, n2)
        _check_caches(c1, c2)
    xl = port_cfg(j_get_reduced("xlstm-125m"))
    with pytest.raises(ValueError, match="model shards"):
        S.make_serve_step(xl, group=group)


# ------------------------------------------------------- the argmax
@pytest.mark.parametrize("m", [2, 3, 4])
def test_vocab_parallel_argmax_ties(m):
    """The argmax of vocab blocks equals ``torch.argmax`` of the whole
    row: many ties within and across blocks (values in {0, 1, 2}), a tie
    between the last entry of one block and the first of the next, NaN,
    and one block's maximum repeated in every block."""
    g = torch.Generator().manual_seed(m)
    V = 12 * m
    rows = torch.randint(0, 3, (6, 1, V), generator=g).float()
    rows[0, 0] = 0.0
    rows[0, 0, V // m - 1] = rows[0, 0, V // m] = 5.0   # across a border
    rows[1, 0, V // m + 1] = float("nan")
    rows[2, 0] = torch.arange(V) % (V // m)           # every block alike
    mesh = _mesh((1, m))
    group = tp.Group.of(mesh, data=0)
    got = tp.vocab_parallel_argmax(list(rows.chunk(m, -1)), group)
    assert torch.equal(got, rows.argmax(-1))
    assert got[0, 0] == V // m - 1
    assert torch.equal(tp.vocab_parallel_argmax([rows], group),
                       rows.argmax(-1))


# ----------------------------------------------------- 2 x 2 against JAX
def _record_routes(monkeypatch):
    """Every tensor-parallel router input and every ``_moe_plan``
    call's ``(expert, slot in the whole batch, kept)``."""
    inputs, plans = [], []
    route, plan = L.moe_route_tp, L._moe_plan

    def spy_route(cfg, ps, x, group):
        inputs.append(x.detach().clone())
        return route(cfg, ps, x, group)

    def spy_plan(cfg, r, T):
        out = plan(cfg, r, T)
        provider = L.split_provider()
        off = 0 if provider is None else \
            provider(T, r[3].sum(0)).offsets[out[0]]
        plans.append((out[0], off + out[1], out[2]))
        return out
    monkeypatch.setattr(L, "moe_route_tp", spy_route)
    monkeypatch.setattr(L, "_moe_plan", spy_plan)
    return inputs, plans


@pytest.mark.parametrize("name", ["attn_window", "moe", "mla",
                                  "mla_moe_q_lora"])
def test_two_by_two_serving_equals_jax_steps(name, monkeypatch):
    """The steps over 2 data x 2 model shards (a batch of 4, 2 rows a
    data shard) against JAX's jitted ``make_prefill_step`` /
    ``make_serve_step`` on the same numpy weights and tokens: tokens
    equal, every cache block within TOL of its part of JAX's caches
    (the data shards' rows joined); each MoE layer's routes equal to
    the whole batch's routing of the router inputs the data shards
    took."""
    jcfg, tcfg = _configs(name)
    host = _numpy_init(jmodel.lm_specs(jcfg), 6)
    params = from_numpy_tree(host, "cpu")
    tok = _tokens(tcfg, rows=4, seed=3)
    L_c = PROMPT + NEW
    jp = jax.tree.map(jnp.asarray, host)
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, cache_len=L_c))
    jdec = jax.jit(jsteps.make_serve_step(jcfg))
    jn, jc = jpre(jp, {"tokens": jnp.asarray(tok.numpy())})
    mesh = _mesh((2, 2))
    groups = [tp.Group.of(mesh, data=i) for i in range(2)]
    trees = [_blocks(params, tcfg, mesh, i) for i in range(2)]
    inputs, plans = _record_routes(monkeypatch)
    pre = S.make_prefill_step(tcfg, cache_len=L_c, group=groups)
    dec = S.make_serve_step(tcfg, group=groups)
    tn, tc = pre(trees, [{"tokens": t} for t in tok.chunk(2)])

    def check(jn, jc, tn, tc):
        assert np.array_equal(np.asarray(jn), torch.cat(tn).numpy())
        joined = [[torch.cat(rows, 1) for rows in zip(
            *(tree_leaves(c[j]) for c in tc))] for j in range(2)]
        _check_caches([torch.from_numpy(np.asarray(a, np.float32))
                       for a in jax.tree.leaves(jc)], joined)
    check(jn, jc, tn, tc)
    for i in range(NEW):
        jn, jc = jdec(jp, jc, jn, jnp.int32(PROMPT + i))
        tn, tc = dec(trees, tc, tn, PROMPT + i)
        check(jn, jc, tn, tc)
    monkeypatch.undo()
    if not {"moe", "mla_moe"} & set(tcfg.block_kinds):
        assert not plans
        return
    assert plans and len(plans) == len(inputs)
    for k in range(0, len(plans), 2):
        whole = torch.cat(inputs[k:k + 2])
        T = whole.shape[0] * whole.shape[1]
        layer_p = params["blocks"][0]["moe"]
        lidx = (k // 2) % tcfg.n_layers
        route = L.moe_route(tcfg, {"router": layer_p["router"][lidx]},
                            whole)
        want = L._moe_plan(tcfg, route, T)[:3]
        for got, w in zip(zip(*plans[k:k + 2]), want):
            assert torch.equal(torch.cat(got), w)


# ----------------------------------------------------- the dry run's cells
# (arch, shape) -> (flash's (heads, Dqk, Dv) a computing coordinate, how
# many coordinates run it, the factor the peak falls by at least): yi-6b's
# 32 heads and deepseek-v2's 128 split over the 16 model coordinates,
# llama4-scout's 40 do not (whole at home); decode runs no flash.  The
# factors sit under the one-layer cells' readings (PERF.md):
# gathered / tensor-parallel 2.48 and 5.13 (yi-6b), 10.9 and 2.95
# (llama4-scout), 12.7 and 7.66 (deepseek-v2)
DRY_CELLS = {
    ("yi-6b", "prefill_32k"): ((2, 128, 128), 16, 2.0),
    ("yi-6b", "decode_32k"): (None, 0, 4.0),
    ("llama4-scout-17b-a16e", "prefill_32k"): ((40, 128, 128), 1, 8.0),
    ("llama4-scout-17b-a16e", "decode_32k"): (None, 0, 2.5),
    ("deepseek-v2-236b", "prefill_32k"): ((8, 192, 128), 16, 10.0),
    ("deepseek-v2-236b", "decode_32k"): (None, 0, 6.0),
}


def _one_layer(monkeypatch, dryrun, arch):
    full = dryrun.get_config(arch)
    cut = full.with_overrides(
        n_layers=1, block_pattern=full.block_pattern[:1]
        if full.block_pattern else None)
    monkeypatch.setattr(dryrun, "get_config", lambda a: cut)
    return cut


def _record_gathers(monkeypatch, dryrun) -> list:
    """Every ``gather`` of a placed leaf: ``(split over model, the model
    index gathered or None: every block)``."""
    seen, orig = [], M.gather

    def spy(p, device, rows=None, where=None):
        seen.append((tp.split_dim(M.NamedSharding(p.mesh, p.spec))
                     is not None, (where or {}).get("model")))
        return orig(p, device, rows=rows, where=where)
    for mod in (M, tp, dryrun):
        monkeypatch.setattr(mod, "gather", spy)
    return seen


@pytest.mark.parametrize("cell", list(DRY_CELLS), ids="-".join)
def test_dryrun_serving_cell_computes_tensor_parallel(cell, monkeypatch):
    """The cell, cut to one layer, computes over data shard 0's 16 model
    coordinates: flash at each coordinate's head count on the planned
    coordinates, no leaf split over ``model`` gathered whole, each
    coordinate's caches its block of JAX's layout (checked in the cell),
    ``argument_bytes`` that of the gathered path (the parent's scheme,
    forced here), and the busiest coordinate's peak below the gathered
    path's by the stated factor."""
    from repro_torch.launch import dryrun
    from repro_torch.models import flash as flash_lib
    arch, shape = cell
    heads_plan, n_coords, factor = DRY_CELLS[cell]
    cfg = _one_layer(monkeypatch, dryrun, arch)
    assert dryrun._tensor_parallel(cfg, dryrun.make_production_mesh(
        devices=[torch.device("meta")] * 256), "data")
    heads, fa = [], flash_lib.flash_attention

    def spy(q, k, v, **kw):
        if M.current_coord() is not None:   # not the layer FLOP probe's
            heads.append((M.current_coord(), (q.shape[2], q.shape[3],
                                              v.shape[3])))
        return fa(q, k, v, **kw)
    monkeypatch.setattr(flash_lib, "flash_attention", spy)
    gathers = _record_gathers(monkeypatch, dryrun)
    rec = dryrun.run_cell(arch, shape, "single", skip_probe=True)
    assert rec["status"] == "ok"
    assert len({c for c, _ in heads}) == n_coords
    assert {h for _, h in heads} == ({heads_plan} if heads_plan else set())
    assert gathers and not [g for g in gathers if g[0] and g[1] is None]
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    monkeypatch.setattr(dryrun, "_tensor_parallel", lambda *a: False)
    gathers.clear()
    base = dryrun.run_cell(arch, shape, "single", skip_probe=True)
    assert [g for g in gathers if g[0] and g[1] is None]
    assert rec["memory"]["argument_bytes"] == \
        base["memory"]["argument_bytes"]
    assert rec["memory"]["peak_per_device"] * factor < \
        base["memory"]["peak_per_device"]


def test_dryrun_xlstm_serving_cell_keeps_the_gathered_path(monkeypatch):
    """xlstm-125m's kinds are outside ``SUPPORTED_KINDS``: its
    ``decode_32k`` cell gathers every leaf whole at each data shard's
    home, as before this slice."""
    from repro_torch.launch import dryrun
    cfg = dryrun.get_config("xlstm-125m")
    assert not dryrun._tensor_parallel(cfg, dryrun.make_production_mesh(
        devices=[torch.device("meta")] * 256), "data")
    gathers = _record_gathers(monkeypatch, dryrun)
    rec = dryrun.run_cell("xlstm-125m", "decode_32k", "single",
                          skip_probe=True)
    assert rec["status"] == "ok"
    assert [g for g in gathers if g[0] and g[1] is None]
