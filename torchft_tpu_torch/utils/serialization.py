"""State-dict flattening, host conversion and the pickled stream.

Twin of ``torchft_tpu/utils/serialization.py``, with ``jax.tree_util``'s
flattening rules so a manifest lists the same leaves, in the same order and
under the same paths, in both packages:

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

:func:`pytree_to_stream` pickles a tree's host copy as the JAX package
does (the legacy full-stream heal, ``GET /checkpoint/{step}``): tensors
become numpy arrays and the containers are rebuilt as ``jax.tree_util``
rebuilds them, so for a tree of plain containers the bytes are the JAX
package's.
"""

from __future__ import annotations

import io
import pickle
from collections import OrderedDict
from typing import Any, BinaryIO, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["dtype_from_str", "dtype_str", "from_host", "host_view",
           "is_tensor_leaf", "pytree_from_bytes", "pytree_from_stream",
           "pytree_to_bytes", "pytree_to_stream", "register_tensor_leaf",
           "to_host", "to_numpy", "tree_flatten_with_path", "tree_leaves",
           "tree_map", "tree_unflatten"]

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


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_flatten_with_path`'s order."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``jax.tree_util.tree_map(fn, tree)`` over the same rules: ``fn`` of
    each leaf in :func:`tree_leaves`' order, the containers rebuilt as
    jax rebuilds them (a dict with its keys sorted, an ``OrderedDict`` in
    its own order, a namedtuple as its class, ``None`` kept)."""
    if isinstance(tree, dict):
        items = [(k, tree_map(fn, tree[k])) for k in _keys(tree)]
        return OrderedDict(items) if isinstance(tree, OrderedDict) \
            else dict(items)
    if isinstance(tree, (list, tuple)):
        subs = [tree_map(fn, v) for v in tree]
        if isinstance(tree, list):
            return subs
        return type(tree)(*subs) if hasattr(tree, "_fields") \
            else tuple(subs)
    if tree is None:
        return None
    return fn(tree)


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


def host_view(t: torch.Tensor) -> np.ndarray:
    """The numpy view of a contiguous CPU tensor, a bfloat16 tensor as
    ml_dtypes' bfloat16 (the JAX package's host bfloat16; numpy has none
    of its own)."""
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError:
        raise TypeError(
            "a bfloat16 tensor reaches the host as ml_dtypes' bfloat16, "
            "and the ml_dtypes package is missing") from None
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def from_host(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a host array (inverse of :func:`host_view`; a
    copy only where ``a`` is not contiguous)."""
    a = np.require(a, requirements=["C"])  # a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(x: Any) -> np.ndarray:
    """A host array of a tensor leaf: a device tensor copied to the host,
    a CPU tensor viewed (copied only where not contiguous), a sharded leaf
    assembled on the host, a numpy array as it is."""
    if isinstance(x, np.ndarray):
        return x
    if not isinstance(x, torch.Tensor):
        x = x.full("cpu")  # a registered sharded leaf
    return host_view(x.detach().to("cpu").contiguous())


def pytree_to_stream(tree: Any, stream: BinaryIO,
                     convert: bool = True) -> None:
    """Pickle (protocol 5) the host copy of ``tree`` into ``stream``: its
    tensor leaves as numpy arrays (:func:`to_numpy`), its containers
    rebuilt as :func:`tree_map` rebuilds them. ``convert=False`` pickles
    a tree that is already that host copy as it is.

    SECURITY: the payload is a pickle, so the checkpoint plane must only
    span mutually trusted trainer hosts (the same trust model as
    ``torch.load(weights_only=False)``)."""
    if convert:
        seen: dict = {}  # a leaf held twice is one host array, pickled once

        def _leaf(x: Any) -> Any:
            if not is_tensor_leaf(x):
                return x
            if id(x) not in seen:
                seen[id(x)] = (x, to_numpy(x))
            return seen[id(x)][1]

        tree = tree_map(_leaf, tree)
    pickle.dump(tree, stream, protocol=5)


def pytree_from_stream(stream: BinaryIO) -> Any:
    return pickle.load(stream)


def pytree_to_bytes(tree: Any) -> bytes:
    buf = io.BytesIO()
    pytree_to_stream(tree, buf)
    return buf.getvalue()


def pytree_from_bytes(data: bytes) -> Any:
    return pytree_from_stream(io.BytesIO(data))
