"""Each routed expert's C slots computed once per microbatch across its
data shards, in the layout JAX compiles (``experts`` over ``model``, the
model width over ``data``): ``models.layers.apply_moe_a2a`` and the
exchanges of ``dist.tensor_parallel`` (``columns_to_slices``,
``gather_slots``, ``sum_partials``, ``rows_to_home``), on virtual CPU
meshes (one device listed 4-8 times), at reduced llama4-scout (4
experts, a shared expert, d 64) with top-1 and top-2 routing, against
JAX's ``apply_moe`` over the whole microbatch and the port's one-device
layer; and the dry run's llama4-scout ``train_4k`` and deepseek-v2
``prefill_32k`` cells cut to one layer, on meta.

Tolerances: the routes, slots and kept flags are the one-device ones to
the bit (the router runs at each home before any exchange); the layer
lies within 1e-5 of its largest entry in f32 and the aux shares add up
to JAX's aux within 1e-5 (the gate and up partials are summed over
``data`` in f32); each coordinate's expert-stack gradient lies within
1e-5 of its slice of the one-device gradient, and so does the input
cotangent.  The dry run's exchange bytes are the reckoning's exactly.
About 35 s with ``-n 6``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL

from repro_torch.dist import mesh as M
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import stage_param_shardings
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.params import from_numpy_tree
from repro_torch.tree import tree_map
from test_torch_families import _numpy_init
from test_torch_moe_tp import _configs, _mesh, _rel, _tilted

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

CPU = torch.device("cpu")
TOL = 1e-5
MESHES = [(2, 2), (4, 2), (2, 4)]


def _cfgs(cf, top_k):
    jcfg, tcfg = _configs(cf)
    moe = dataclasses.replace(jcfg.moe, top_k=top_k)
    return (dataclasses.replace(jcfg, moe=moe),
            tcfg.with_overrides(moe=dataclasses.replace(tcfg.moe,
                                                        top_k=top_k)))


def _sliced(tree, specs, mesh):
    """``blocks[i][j]``: data shard ``i``'s model shard ``j``'s MoE tree,
    its routed expert stacks its data slice (``gather_block`` with
    ``data``), every other leaf as the tensor-parallel path gathers
    it."""
    placed = tree_map(M.place_as, {"moe": tree},
                      stage_param_shardings({"moe": specs}, mesh))
    n, m = mesh.shape["data"], mesh.shape["model"]
    return [[tp.gather_block(placed, CPU, j, data=i)["moe"]
             for j in range(m)] for i in range(n)]


def _layer(tcfg, blocks, x, mesh):
    groups = [tp.Group.of(mesh, data=i) for i in range(len(blocks))]
    return L.apply_moe_a2a(tcfg, blocks, list(x.chunk(len(groups))),
                           groups)


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x2", "2x4"])
def test_layer_equals_jax_whole_microbatch(shape, cf, monkeypatch):
    """The layer against JAX's ``apply_moe`` over the whole microbatch in
    f32, top-2, with the capacity binding: within 1e-5 of its largest
    entry, the aux shares adding up to JAX's aux; the routes, global
    slots and kept flags the one-device ``moe_route`` / ``_moe_plan``'s
    to the bit; every coordinate's buffer ``[E / m, C, d / n]`` and none
    ``[E / m, Cb, d]``, together ``E C d`` elements, not ``n E Cb d``."""
    jcfg, tcfg = _cfgs(cf, 2)
    n, m = shape
    host = _numpy_init(jL.moe_specs(jcfg), 3)
    x = _tilted(2 * n, jcfg.d_model)
    jy, jaux = jax.jit(functools.partial(jL.apply_moe, jcfg))(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    p = from_numpy_tree(host, "cpu")
    mesh = _mesh(shape)
    blocks = _sliced(p, L.moe_specs(tcfg), mesh)
    E, d, k = tcfg.moe.num_experts, tcfg.d_model, tcfg.moe.top_k
    assert blocks[0][0]["wi_gate"].shape == (E // m, d // n,
                                             tcfg.moe.d_ff_expert)
    assert blocks[0][0]["wo"].shape == (E // m, tcfg.moe.d_ff_expert,
                                        d // n)
    seen, slots = [], []
    dispatch, gather_slots = L._dispatch, tp.gather_slots

    def spy_dispatch(*a):
        out = dispatch(*a)
        seen.append((M.current_coord(), tuple(out.shape)))
        return out

    def spy_slots(s, *a, **kw):
        slots.append([t.clone() for t in s])
        return gather_slots(s, *a, **kw)
    monkeypatch.setattr(L, "_dispatch", spy_dispatch)
    monkeypatch.setattr(tp, "gather_slots", spy_slots)
    xt = torch.from_numpy(x)
    ys, auxs = _layer(tcfg, blocks, xt, mesh)
    assert _rel(torch.cat(ys).numpy(), jy) <= TOL
    aux = sum(float(a) for a in auxs)
    assert abs(aux - float(jaux)) <= TOL * abs(float(jaux))
    # the one-device routing of the whole microbatch
    T = xt.shape[0] * xt.shape[1]
    route = L.moe_route(tcfg, p, xt)
    e1, pos1, keep1, C, _ = L._moe_plan(tcfg, route, T)
    assert int((~keep1).sum()) > 0                # the capacity binds
    assert torch.equal(torch.cat(slots[0]).long(),
                       torch.where(keep1, e1 * C + pos1, -1))
    rows = [L.moe_route(tcfg, p, c) for c in xt.chunk(n)]
    for a, b in zip(zip(*rows), route):
        assert torch.equal(torch.cat(a), b)
    # each coordinate's buffer, once per microbatch
    Cb = min(C, T // n * k)
    assert {s for _, s in seen} == {(E // m, C, d // n)}
    assert len({c for c, _ in seen}) == n * m
    assert (E // m, Cb, d) not in {s for _, s in seen}
    assert sum(np.prod(s) for _, s in seen) == E * C * d


def test_rows_from_home_alone_miss_jax(monkeypatch):
    """Control for the layer test: each pair's row slices taken from
    home's model shard only (``rows_to_home`` never selecting the owner,
    so the other experts' pairs stay zero) misses JAX's whole-microbatch
    ``apply_moe`` by far more than the bound."""
    jcfg, tcfg = _cfgs(1.25, 2)
    host = _numpy_init(jL.moe_specs(jcfg), 3)
    x = _tilted(4, jcfg.d_model)
    jy, _ = jax.jit(functools.partial(jL.apply_moe, jcfg))(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    mesh = _mesh((2, 2))
    blocks = _sliced(from_numpy_tree(host, "cpu"), L.moe_specs(tcfg), mesh)
    monkeypatch.setattr(tp, "rows_to_home", lambda parts, owner, home, cols:
                        torch.cat([row[0] for row in parts], dim=1))
    ys, _ = _layer(tcfg, blocks, torch.from_numpy(x), mesh)
    assert _rel(torch.cat(ys).numpy(), jy) > 1e-2


def test_capacity_binds_in_the_layer_tests():
    """The inputs the layer tests use overflow an expert at both capacity
    factors: the kept flags are not all true."""
    for cf in (0.5, 1.25):
        _, tcfg = _cfgs(cf, 2)
        p = P.init(3, L.moe_specs(tcfg), "cpu")
        x = torch.from_numpy(_tilted(4, tcfg.d_model))
        T = x.shape[0] * x.shape[1]
        keep = L._moe_plan(tcfg, L.moe_route(tcfg, p, x), T)[2]
        assert int((~keep).sum()) > 0


def _leaves(blocks):
    return [[tree_map(lambda a: a.detach().requires_grad_(), t) for t in row]
            for row in blocks]


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x2", "2x4"])
def test_gradients_are_the_slices_of_one_device(shape, top_k):
    """A random cotangent through the layer and its aux: every
    coordinate's ``wi_gate`` / ``wi_up`` / ``wo`` gradient within 1e-5
    of its slice of the one-device gradient (each the whole
    microbatch's, summed over nothing), and the input cotangent within
    1e-5."""
    _, tcfg = _cfgs(1.25, top_k)
    n, m = shape
    p = P.init(5, L.moe_specs(tcfg), "cpu")
    mesh = _mesh(shape)
    blocks = _leaves(_sliced(p, L.moe_specs(tcfg), mesh))
    x = torch.from_numpy(_tilted(2 * n, tcfg.d_model, seed=11))
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    xs = [c.clone().requires_grad_() for c in x.chunk(n)]
    groups = [tp.Group.of(mesh, data=i) for i in range(n)]
    ys, auxs = L.apply_moe_a2a(tcfg, blocks, xs, groups)
    loss = sum((y * c).sum() for y, c in zip(ys, w.chunk(n))) + sum(auxs)
    stacks = ("wi_gate", "wi_up", "wo")
    wrt = [blocks[i][j][s] for i in range(n) for j in range(m)
           for s in stacks] + xs
    got = torch.autograd.grad(loss, wrt)
    p1 = tree_map(lambda a: a.detach().requires_grad_(), p)
    x1 = x.clone().requires_grad_()
    y1, a1 = L.apply_moe(tcfg, p1, x1)
    want = torch.autograd.grad((y1 * w).sum() + a1,
                               [p1[s] for s in stacks] + [x1])
    E, d = tcfg.moe.num_experts, tcfg.d_model
    Ep, dn = E // m, d // n
    k = 0
    for i in range(n):
        for j in range(m):
            for s, g1 in zip(stacks, want):
                blk = g1[j * Ep:(j + 1) * Ep]
                blk = (blk[..., i * dn:(i + 1) * dn] if s == "wo"
                       else blk[:, i * dn:(i + 1) * dn])
                assert got[k].shape == blk.shape
                assert _rel(got[k].numpy(), blk.numpy()) <= TOL
                k += 1
    assert _rel(torch.cat(got[k:]).numpy(), want[-1].numpy()) <= TOL


def test_one_layer_pass_logs_each_exchange_once():
    """A forward over (2, 4) without the shared expert: each exchange
    counted once under its name (the router gather once a data shard),
    and the bytes each coordinate receives the reckoning's: the columns
    ``(n - 1) T_s d / n``, the slots ``(n - 1) T_s k`` int32, the gate
    and up sums ``2 E / m C f`` f32 each, and at each home every other
    coordinate's row slices ``(n m - 1) T_s k d / n``."""
    _, tcfg = _cfgs(1.25, 2)
    tcfg = tcfg.with_overrides(moe=dataclasses.replace(tcfg.moe,
                                                       num_shared=0))
    n, m = 2, 4
    mesh = _mesh((n, m))
    p = P.init(7, L.moe_specs(tcfg), "cpu")
    blocks = _sliced(p, L.moe_specs(tcfg), mesh)
    x = torch.from_numpy(_tilted(2 * n, tcfg.d_model))
    tp.ALL_REDUCES.clear()
    with torch.no_grad(), M.record_collectives() as rec:
        _layer(tcfg, blocks, x, mesh)
    assert dict(tp.ALL_REDUCES) == {
        "router": n, "expert_columns": 1, "expert_slots": 1,
        "expert_partials": 2, "expert_rows": 1}
    E, d, k, f = (tcfg.moe.num_experts, tcfg.d_model, tcfg.moe.top_k,
                  tcfg.moe.d_ff_expert)
    Ts = x.shape[0] * x.shape[1] // n
    C = int(tcfg.moe.capacity_factor * Ts * n * k / E)
    router = (m - 1) * d * (E // m) * 4
    for c in mesh.coords():
        home = c[1] == 0
        by = rec.bytes[c]
        assert by["all-to-all"] == (n - 1) * Ts * (d // n) * 4 + (
            (n * m - 1) * Ts * k * (d // n) * 4 if home else 0)
        assert by["all-gather"] == (n - 1) * Ts * k * 4 + (
            router if home else 0)
        assert by["all-reduce"] == 2 * (E // m) * C * f * 4
        assert rec.counts[c]["all-reduce"] == 2


def test_dispatch_fills_each_kept_slot_once():
    """``_dispatch``: a kept pair's row in its slot of the model shard
    that owns its expert, dropped pairs (-1) and other shards' pairs
    nowhere; ``_pair_rows`` reads them back, zeros elsewhere."""
    cols = torch.arange(12.0).reshape(6, 2)
    # 3 tokens x top-2: global slots over 2 experts a shard of C 2
    slots = torch.tensor([0, 5, 1, -1, 4, 2], dtype=torch.int32)
    buf = L._dispatch(cols.repeat_interleave(1, 0)[:3], slots, 0, 2, 2, 2)
    assert buf.shape == (2, 2, 2)
    want = torch.zeros(2, 2, 2)
    want[0, 0], want[0, 1], want[1, 0] = cols[0], cols[1], cols[2]
    assert torch.equal(buf, want)
    back = L._pair_rows(buf, slots, 0)
    assert torch.equal(back[[0, 2, 5]], cols[[0, 1, 2]])
    assert not back[[1, 3, 4]].any()


# ---------------------------------------------------------------- meta
def _one_layer(monkeypatch, arch):
    from repro_torch.launch import dryrun
    full = dryrun.get_config(arch)
    cut = full.with_overrides(n_layers=1, block_pattern=(
        full.block_pattern[:1] if full.block_pattern else None))
    monkeypatch.setattr(dryrun, "get_config", lambda a: cut)
    return dryrun, cut


@pytest.mark.parametrize("arch,shape", [
    ("llama4-scout-17b-a16e", "train_4k"),
    ("deepseek-v2-236b", "prefill_32k")])
def test_dryrun_exchange_bytes_are_the_reckoning(arch, shape, monkeypatch):
    """The dry run's cell cut to one layer: home receives, as all-to-all,
    the columns ``15 T_s d / 16`` a pass (forward, recompute and the
    backward's transpose in training) and every other coordinate's row
    slices ``255 T_s k d / 16`` a forward pass (forward and recompute);
    its expert partials' all-reduces carry ``2 E / 16 C f`` f32 a pass
    (twice more in backward), its slot all-gathers ``15 T_s k`` int32 a
    forward pass; every coordinate's buffer is ``[E / 16, C, d / 16]``
    and no coordinate holds an ``[E, ., .]`` MoE tensor."""
    dryrun, cfg = _one_layer(monkeypatch, arch)
    got = {"all-reduce": 0, "all-gather": 0}
    log = tp.Column.log

    def spy(self, kind, nbytes):
        if kind in got and self.coords[0] == (0, 0):   # home's column
            got[kind] += nbytes[0]
        return log(self, kind, nbytes)
    monkeypatch.setattr(tp.Column, "log", spy)
    shapes = []
    dispatch = L._dispatch

    def spy_dispatch(*a):
        out = dispatch(*a)
        shapes.append((M.current_coord(), tuple(out.shape)))
        return out
    monkeypatch.setattr(L, "_dispatch", spy_dispatch)
    rec = dryrun.run_cell(arch, shape, "single", skip_probe=True)
    assert rec["status"] == "ok" and rec["device"] == [0, 0]
    s = dryrun.SHAPES[shape]
    mo, d, n = cfg.moe, cfg.d_model, 16
    T = s.global_batch * s.seq_len
    Ts, k, E, f = T // n, mo.top_k, mo.num_experts, mo.d_ff_expert
    C = int(mo.capacity_factor * T * k / E)
    train = s.kind == "train"
    fwd = 2 if train else 1                  # forward and recompute
    cols = (n - 1) * Ts * (d // n) * 2
    rows = (n * n - 1) * Ts * k * (d // n) * 2
    assert rec["collectives"]["bytes"]["all-to-all"] == \
        cols * (fwd + train) + rows * fwd
    assert got["all-reduce"] == 2 * (E // n) * C * f * 4 * (fwd + train)
    assert got["all-gather"] == (n - 1) * Ts * k * 4 * fwd
    assert {sh for _, sh in shapes} == {(E // n, C, d // n)}
    assert len({c for c, _ in shapes}) == n
