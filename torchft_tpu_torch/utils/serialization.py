"""State-dict flattening and host conversion for the heal wire.

Twin of the part of ``torchft_tpu/utils/serialization.py`` the heal plane
needs, with ``jax.tree_util``'s flattening rules so a manifest lists the
same leaves, in the same order and under the same paths, in both packages:

- a ``dict`` is walked in sorted key order, an ``OrderedDict`` in
  insertion order (``nn.Module.state_dict()`` returns one);
- lists and tuples in order; ``None`` is an empty subtree (no leaf);
- everything else is a leaf: torch tensors, numpy arrays and
  ``parallel.sharding.ShardedTensor`` s (the tensor leaves, whose bytes
  ride the wire raw; a sharded leaf is one leaf, as the reference's
  sharded ``jax.Array``) and any other value (an object leaf: the step
  counters, an optimizer's hyperparameters).

Paths are ``jax.tree_util.keystr``'s: a dict key ``k`` as ``[repr(k)]``, a
list or tuple index ``i`` as ``[i]``, e.g. ``['user']['optim']['state'][3]
['exp_avg']``. The structure spec of :func:`tree_flatten_with_path` holds
only builtins and ``collections.OrderedDict``, so an unpickler of either
package reads it without importing this one.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = ["dtype_from_str", "dtype_str", "is_tensor_leaf",
           "register_tensor_leaf", "to_host", "tree_flatten_with_path",
           "tree_unflatten"]

# The leaf types whose bytes ride the tensor wire. ``parallel/sharding.py``
# registers ``ShardedTensor`` as it loads: utils sits below parallel and
# imports none of it, and a sharded leaf cannot exist before its module.
_TENSOR_TYPES: Tuple[type, ...] = (torch.Tensor, np.ndarray)


def register_tensor_leaf(cls: type) -> None:
    """Count instances of ``cls`` as tensor leaves."""
    global _TENSOR_TYPES
    if cls not in _TENSOR_TYPES:
        _TENSOR_TYPES = _TENSOR_TYPES + (cls,)


def is_tensor_leaf(x: Any) -> bool:
    """A leaf whose bytes ride the tensor wire (a torch tensor, a numpy
    array or a ``ShardedTensor``); every other leaf is an object leaf."""
    return isinstance(x, _TENSOR_TYPES)


def _keys(x: dict) -> list:
    """A dict's keys in the JAX package's flattening order: sorted, or in
    insertion order for an ``OrderedDict`` (and where keys do not sort)."""
    if isinstance(x, OrderedDict):
        return list(x)
    try:
        return sorted(x)
    except TypeError:
        return list(x)


def tree_flatten_with_path(state: Any) -> Tuple[List[Tuple[str, Any]], Any]:
    """``([(path, leaf), ...], spec)`` in ``jax.tree_util.
    tree_flatten_with_path``'s order. ``spec`` is the structure with leaf
    ``i`` as ``("leaf", i)``: dicts as ``("dict" | "odict", [(key, sub),
    ...])`` in their own key order, ``("list" | "tuple", [sub, ...])`` and
    ``("none",)``."""
    flat: List[Tuple[str, Any]] = []

    def walk(x: Any, path: str) -> Any:
        if isinstance(x, dict):
            subs = {k: walk(x[k], f"{path}[{k!r}]") for k in _keys(x)}
            tag = "odict" if isinstance(x, OrderedDict) else "dict"
            return (tag, [(k, subs[k]) for k in x])
        if isinstance(x, (list, tuple)):
            tag = "tuple" if isinstance(x, tuple) else "list"
            return (tag, [walk(v, f"{path}[{i}]") for i, v in enumerate(x)])
        if x is None:
            return ("none",)
        flat.append((path, x))
        return ("leaf", len(flat) - 1)

    return flat, walk(state, "")


def tree_unflatten(spec: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`tree_flatten_with_path`."""
    tag = spec[0]
    if tag == "leaf":
        return leaves[spec[1]]
    if tag == "none":
        return None
    if tag in ("dict", "odict"):
        items = [(k, tree_unflatten(s, leaves)) for k, s in spec[1]]
        return OrderedDict(items) if tag == "odict" else dict(items)
    subs = [tree_unflatten(s, leaves) for s in spec[1]]
    return tuple(subs) if tag == "tuple" else subs


def dtype_str(dtype: Any) -> str:
    """Wire name of a leaf dtype, the JAX package's (numpy's) name for
    either kind: ``"float32"``, ``"bfloat16"`` (ml_dtypes' name there),
    ``"int64"``, ``"bool"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype)[len("torch."):]
    return np.dtype(dtype).name


def dtype_from_str(name: str, tensor: bool = False) -> Any:
    """The dtype a wire name stands for: a torch dtype when ``tensor`` or
    when numpy has no such dtype (``"bfloat16"``, the float8 types), else a
    numpy dtype."""
    if not tensor:
        try:
            return np.dtype(name)
        except TypeError:
            pass
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy of tensor ``t`` (any dtype, any device; a copy
    even for a CPU tensor)."""
    return t.detach().to("cpu", copy=True).contiguous()
