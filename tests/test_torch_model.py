"""The port's serving model path against the JAX package on shared
weights: ``lm_prefill`` / ``lm_decode_step`` (logits and every cache
leaf) under both ``kernels`` values, and ``split_lm_params``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config

from repro.models import model as jm
from repro.models import params as jp
from repro.runtime.stage_model import split_lm_params as j_split

from repro_torch.models import model as tm
from repro_torch.models.config import ArchConfig as TorchArchConfig
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.runtime.stage_model import split_lm_params as t_split
from repro_torch.tree import tree_leaves

TOL = 1e-5


def port_cfg(cfg):
    return TorchArchConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)})


def assert_close(a, b, tol=TOL):
    """|a - b| <= tol relative to the leaf's scale: activations and
    caches here reach |x| ~ 30, where f32 summation order alone moves the
    last digits."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (err, tol * scale)


def _shared(kernels="jnp", seed=0):
    cfg = tiny_dense_config(kernels=kernels)
    jparams = jp.init(jax.random.PRNGKey(seed), jm.lm_specs(cfg))
    tparams = from_numpy_tree(jax.device_get(jparams), "cpu")
    return cfg, port_cfg(cfg), jparams, tparams


@pytest.mark.parametrize("kernels", ["jnp", "pallas"])
def test_prefill_and_decode_match_jax(kernels):
    cfg, tcfg, jparams, tparams = _shared(kernels)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = jm.lm_prefill(cfg, jparams, jnp.asarray(toks), cache_len=16)
    with torch.inference_mode():
        tl, tc = tm.lm_prefill(tcfg, tparams, torch.as_tensor(toks),
                               cache_len=16)
    assert_close(tl.numpy(), jl)
    jleaves = jax.tree.leaves(jax.device_get(jc))
    tleaves = tree_leaves(to_numpy_tree(tc))
    assert len(jleaves) == len(tleaves) == 2
    for a, b in zip(tleaves, jleaves):
        assert_close(a, b)
    tok = np.argmax(np.asarray(jl)[:, -1:], -1).astype(np.int32)
    for step in range(2):
        jl, jc = jm.lm_decode_step(cfg, jparams, jnp.asarray(tok), jc,
                                   jnp.int32(12 + step))
        with torch.inference_mode():
            tl, tc = tm.lm_decode_step(tcfg, tparams, torch.as_tensor(tok),
                                       tc, 12 + step)
        assert_close(tl.numpy(), jl)
        for a, b in zip(tree_leaves(to_numpy_tree(tc)),
                        jax.tree.leaves(jax.device_get(jc))):
            assert_close(a, b)
        np.testing.assert_array_equal(np.argmax(tl.numpy(), -1),
                                      np.argmax(np.asarray(jl), -1))
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)


@pytest.mark.parametrize("n_stages", [4, 2])
def test_split_lm_params_matches_jax_as_views(n_stages):
    cfg, tcfg, jparams, tparams = _shared()
    jst = j_split(cfg, n_stages, jparams)
    tst = t_split(tcfg, n_stages, tparams)
    assert len(jst) == len(tst) == n_stages
    full_ptrs = {t.untyped_storage().data_ptr()
                 for t in tree_leaves(tparams)}
    for js, ts in zip(jst, tst):
        assert jax.tree.structure(js) == jax.tree.structure(
            jax.tree.map(lambda x: 0, to_numpy_tree(ts)))
        for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            # every stage leaf is a view of the full tree: no copy
            assert a.untyped_storage().data_ptr() in full_ptrs


def test_param_specs_match_jax():
    cfg = tiny_dense_config()
    jspecs = jax.tree.leaves(jm.lm_specs(cfg),
                             is_leaf=lambda x: isinstance(x, jp.ParamSpec))
    tspecs = tree_leaves(tm.lm_specs(port_cfg(cfg)),
                         is_leaf=lambda x: hasattr(x, "init"))
    assert [(s.shape, s.init, s.axes) for s in jspecs] == \
        [(s.shape, s.init, s.axes) for s in tspecs]
