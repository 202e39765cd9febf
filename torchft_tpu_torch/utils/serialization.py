"""State-dict flattening and host conversion for the heal wire.

Twin of the part of ``torchft_tpu/utils/serialization.py`` the heal plane
needs. A state dict (nested dicts, lists and tuples, as
``nn.Module.state_dict()`` and ``torch.optim.Optimizer.state_dict()``
produce) is split into its tensor leaves (torch tensors and numpy arrays)
and a structure spec that holds every other value, so tensor bytes ride
the wire raw and only the spec is pickled.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = ["dtype_from_str", "dtype_str", "flatten_state", "leaf_paths",
           "to_host", "unflatten_state"]


class _Leaf:
    """Placeholder for tensor leaf ``index`` inside a structure spec."""

    __slots__ = ("index",)

    def __init__(self, index: int) -> None:
        self.index = index

    def __reduce__(self):
        return (_Leaf, (self.index,))


def flatten_state(state: Any) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``: the tensors and arrays of ``state`` in a
    deterministic depth-first order (dict insertion order), and ``state``
    with each of them replaced by a placeholder."""
    leaves: List[Any] = []

    def walk(x: Any) -> Any:
        if isinstance(x, (torch.Tensor, np.ndarray)):
            leaves.append(x)
            return _Leaf(len(leaves) - 1)
        if isinstance(x, dict):
            return type(x)((k, walk(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return leaves, walk(state)


def leaf_paths(state: Any) -> List[str]:
    """The path of every leaf of :func:`flatten_state`, in its order, in
    the JAX package's key-string format (``jax.tree_util.keystr``): a dict
    key ``k`` as ``[repr(k)]``, a list or tuple index ``i`` as ``[i]``,
    e.g. ``['train']['opt']['slots'][3][0]``. The JAX package walks dicts
    in sorted key order and this package in insertion order, so leaves are
    matched across packages by path, never by index."""
    paths: List[str] = []

    def walk(x: Any, path: str) -> None:
        if isinstance(x, (torch.Tensor, np.ndarray)):
            paths.append(path)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")

    walk(state, "")
    return paths


def unflatten_state(spec: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`flatten_state`."""

    def walk(x: Any) -> Any:
        if isinstance(x, _Leaf):
            return leaves[x.index]
        if isinstance(x, dict):
            return type(x)((k, walk(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(spec)


def dtype_str(dtype: Any) -> str:
    """Wire name of a leaf dtype: ``"torch.bfloat16"`` for torch dtypes,
    numpy's name (``"float32"``) for numpy ones."""
    if isinstance(dtype, torch.dtype):
        return str(dtype)
    return np.dtype(dtype).name


def dtype_from_str(name: str) -> Any:
    if name.startswith("torch."):
        dt = getattr(torch, name[len("torch."):], None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown torch dtype {name!r}")
        return dt
    return np.dtype(name)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host snapshot of tensor ``t`` as a flat uint8 array of its bytes
    (any dtype, any device; a copy even for a CPU tensor)."""
    host = t.detach().to("cpu", copy=True).contiguous()
    return host.reshape(-1).view(torch.uint8).numpy()
