"""Parameter specification framework (port of ``repro.models.params``).

A model is a tree of :class:`ParamSpec`s; ``init`` materializes it into
a tree of tensors on one device.  Initialisation follows the JAX
package's rules (``_init_one``: zeros / ones / embed-normal / truncated
normal at ``scale / sqrt(fan_in)``) with an explicit
``torch.Generator``, so the numbers differ from jax's threefry stream —
parity tests share weights through :func:`from_numpy_tree`, not seeds.

``from_numpy_tree`` / ``to_numpy_tree`` carry trees across the two
packages: a JAX tree pulled to host with ``jax.device_get`` becomes the
port's tree leaf by leaf (stacked ``[n_layers, ...]`` leaves stay
stacked), and back.  bfloat16 leaves cross as ``ml_dtypes.bfloat16``
numpy arrays, the type ``jax.device_get`` returns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape + dtype + init + logical axes for one parameter tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"          # normal | zeros | ones | embed | scaled
    axes: tuple[str, ...] = ()    # logical axis names, len == len(shape)
    scale: float = 1.0            # stddev multiplier for normal/scaled init

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} do not match shape {self.shape}")


def _fan_in(shape: Sequence[int]) -> int:
    # For stacked-layer weights [L, in, out] the fan-in is the middle dim.
    if len(shape) >= 2:
        return shape[-2]
    return max(1, shape[-1])


def _init_one(gen: torch.Generator, spec: ParamSpec,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    x = torch.empty(spec.shape, dtype=torch.float32, device=device)
    if spec.init == "embed":
        x.normal_(0.0, 1.0 * spec.scale, generator=gen)
        return x.to(spec.dtype)
    # normal / scaled: truncated-normal on [-2, 2], std = scale/sqrt(fan_in)
    std = spec.scale / math.sqrt(_fan_in(spec.shape))
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(std).to(spec.dtype)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def init(seed: int, specs: Tree, device="cuda") -> Tree:
    """Materialize a ParamSpec tree into tensors on ``device``, drawing
    every leaf from one generator seeded with ``seed`` in the tree's
    flattened (sorted-key) order."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves = tree_leaves(specs, is_leaf=is_spec)
    return tree_unflatten_like(
        specs, [_init_one(gen, s, device) for s in leaves], is_leaf=is_spec)


def n_params(specs: Tree) -> int:
    return sum(int(np.prod(s.shape))
               for s in tree_leaves(specs, is_leaf=is_spec))


def resolve_device(device) -> torch.device:
    """The port's device rule: what the caller names, never a silent
    substitute — asking for CUDA on a machine without it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return device


# ------------------------------------------------------ numpy interchange
def _bf16_numpy_type():
    try:
        import ml_dtypes
    except ImportError as e:                   # pragma: no cover
        raise TypeError("bfloat16 leaves cross to numpy as "
                        "ml_dtypes.bfloat16; ml_dtypes is not installed"
                        ) from e
    return ml_dtypes.bfloat16


def tensor_from_numpy(a, device, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:             # jax.device_get hands out
        a = a.copy()                      # read-only views
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(
            _bf16_numpy_type())
    return t.numpy()


def _is_array(x) -> bool:
    return isinstance(x, np.ndarray) or (hasattr(x, "shape")
                                          and hasattr(x, "dtype")
                                          and not isinstance(x, torch.Tensor))


def from_numpy_tree(tree: Tree, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Tree:
    """A host (numpy) tree -> the same tree of tensors on ``device``
    (floating leaves cast to ``dtype`` when given).  Python scalars pass
    through unchanged."""
    device = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, device, dtype)
                    if _is_array(a) else a, tree)


def to_numpy_tree(tree: Tree) -> Tree:
    """Inverse of :func:`from_numpy_tree`: every tensor leaf to numpy."""
    return tree_map(lambda t: tensor_to_numpy(t)
                    if isinstance(t, torch.Tensor) else t, tree)
