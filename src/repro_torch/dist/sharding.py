"""Logical-axis -> mesh-axis sharding rules and their sharding builders
(port of ``repro.dist.sharding``).

Every parameter and cache tensor carries logical axis names on its
:class:`~repro_torch.models.params.ParamSpec` (``("embed", "heads",
"head_dim")`` and so on).  :class:`ShardingRules` maps them onto the
production mesh ``("pod", "data", "model")`` with the two safety rules of
:func:`repro_torch.dist.constrain.resolve_spec`: a dim that does not
divide its mesh axes replicates (4 kv-heads on a 16-way ``model`` axis),
and a mesh axis is used once per spec (a square ``("mlp", "embed2")``
weight).

``DEFAULT_RULES`` is FSDP over ``data`` + tensor-parallel storage over
``model``; ``pod`` is the pipeline's (``state_shardings(...,
pipeline=True)`` maps the stacked ``layers`` dim onto it).  The builders
return trees of :class:`~repro_torch.dist.mesh.NamedSharding`, whose
``spec`` equals the JAX package's ``PartitionSpec`` entry for entry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.dist.constrain import AxisSpec, resolve_spec
from repro_torch.dist.mesh import NamedSharding
from repro_torch.models import params as P
from repro_torch.tree import tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """One ``logical axis name -> mesh axes`` table (str | tuple | None)."""

    rules: dict[str, AxisSpec]

    def with_rules(self, **overrides: AxisSpec) -> "ShardingRules":
        return ShardingRules(rules={**self.rules, **overrides})

    def spec_for(self, names, shape, mesh) -> tuple:
        """The resolved spec of one tensor with logical ``names``."""
        return resolve_spec([self.rules.get(n) for n in names], shape, mesh)

    def sharding_for(self, spec: P.ParamSpec, mesh) -> NamedSharding:
        return NamedSharding(mesh, self.spec_for(spec.axes, spec.shape,
                                                 mesh))


DEFAULT_RULES = ShardingRules(rules={
    # structural dims
    "layers": None,           # stacked-layer dim; -> "pod" under pipeline
    "stage": "pod",
    # weight dims
    "embed": "data",          # FSDP: shard the embed dim over data
    "embed2": "model",        # second embed dim of square projections
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qk_dim": None,
    "v_dim": None,
    "vocab": "model",
    "experts": "model",       # expert parallelism shares the model axis
    "expert_mlp": None,
    "kv_lora": None,
    "q_lora": None,
    "bottleneck": "model",    # the codec's wire dim, TP like "mlp"
    "state": None,
    "conv": None,
    "pos": None,
    "null": None,
    # activation / cache dims
    "batch": ("pod", "data"),
    "kv_seq": None,
})


def _model_specs(cfg) -> Tree:
    from repro_torch.train import steps as steps_lib   # lazy: steps
    return steps_lib.model_specs(cfg)                  # imports models


def _spec_shardings(spec_tree: Tree, mesh, rules: ShardingRules) -> Tree:
    return tree_map(lambda s: rules.sharding_for(s, mesh), spec_tree,
                    is_leaf=P.is_spec)


def param_shardings(cfg, mesh, rules: Optional[ShardingRules] = None
                    ) -> Tree:
    """The sharding tree of ``model_specs(cfg)`` / the params tree."""
    return _spec_shardings(_model_specs(cfg), mesh, rules or DEFAULT_RULES)


def stage_param_shardings(specs: Tree, mesh,
                          rules: Optional[ShardingRules] = None) -> Tree:
    """The sharding tree of any ParamSpec tree, e.g. one stage program's
    ``specs``: how :class:`repro_torch.runtime.mesh.MeshExecutor` lays a
    stage's parameters out on its peer's mesh."""
    return _spec_shardings(specs, mesh, rules or DEFAULT_RULES)


def state_shardings(cfg, mesh, *, pipeline: bool = False,
                    rules: Optional[ShardingRules] = None) -> Tree:
    """Shardings of the ``{"params", "opt", "step"}`` AdamW state.
    ``pipeline=True`` also maps the stacked ``layers`` dim (and the
    codecs' ``stage`` dim) onto ``pod``, so each pipeline stage owns its
    slice of every layer-stacked weight and of its moments."""
    rules = rules or DEFAULT_RULES
    if pipeline:
        rules = rules.with_rules(layers="pod", stage="pod")
    psh = param_shardings(cfg, mesh, rules)
    repl = NamedSharding(mesh, ())
    return {"params": psh,
            "opt": {"m": psh, "v": psh, "count": repl},
            "step": repl}


def batch_shardings(cfg, mesh, specs: Tree,
                    batch_axis: AxisSpec = ("pod", "data")) -> Tree:
    """Shardings of an input-batch tree (leaves with ``shape``, e.g. the
    meta tensors of ``train.steps.train_batch_specs``): the batch dim
    over ``batch_axis``.  M-RoPE ``positions`` are ``[3, B, S]``, batch
    at dim 1; every other leaf is batch-major."""
    del cfg

    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        axes: list[AxisSpec] = [batch_axis] + [None] * (len(t.shape) - 1)
        if name == "positions" and len(t.shape) >= 2:
            axes = [None, batch_axis] + [None] * (len(t.shape) - 2)
        return NamedSharding(mesh, resolve_spec(axes, t.shape, mesh))

    return walk(specs, None)


def cache_shardings_from_specs(cfg, mesh, specs: Tree,
                               batch_axis: AxisSpec = ("pod", "data"),
                               rules: Optional[ShardingRules] = None
                               ) -> Tree:
    """Shardings of decode-cache ParamSpec trees: the param rules, with
    the ``batch`` dim on the cell's ``batch_axis`` (inference folds
    ``pod`` into data parallelism, so the caller decides)."""
    del cfg
    rules = (rules or DEFAULT_RULES).with_rules(batch=batch_axis)
    return _spec_shardings(specs, mesh, rules)
