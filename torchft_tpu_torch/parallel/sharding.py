"""Parameter sharding rules: FSDP and tensor-parallel layouts, and the
sharded leaf that holds them.

Twin of ``torchft_tpu/parallel/sharding.py``, with the same rules in the
same order:

- **FSDP**: a parameter is sharded on its largest divisible dimension over
  the ``fsdp`` axis; a parameter with no divisible dimension (or 0-d)
  stays replicated.
- **TP**: regular expressions over the parameter's path (the JAX
  package's ``layers_0/attn/q_proj/kernel``) place matmul weights column-
  or row-parallel on the ``tensor`` axis (Megatron's layout: q/k/v and
  the MLP's up projection column-split, the attention's output and the
  MLP's down projection row-split), the token embedding and the lm head
  on the vocabulary.

The reference hands its ``NamedSharding`` s to ``jax.device_put`` and lets
XLA insert the collectives. The port has no compiler to do that: its own
:class:`PartitionSpec` and :class:`NamedSharding` describe a layout over
the port's :class:`~torchft_tpu_torch.parallel.mesh.Mesh`, and a
:class:`ShardedTensor` holds a leaf in it, one torch tensor per distinct
(global bounds, device) pair. On a virtual mesh (one card repeated) each
distinct region is held once; over four cards a leaf's pieces are what
the reference's ``addressable_shards`` hold. The model that computes on
such leaves runs the mesh's coordinates in lock-step
(``models.transformer.ShardedGPT``).
"""

from __future__ import annotations

import re
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from torchft_tpu_torch.utils.serialization import register_tensor_leaf

__all__ = [
    "NamedSharding",
    "PartitionSpec",
    "ShardedTensor",
    "TpRule",
    "fsdp_sharding",
    "make_sharding_fn",
    "replicated",
    "shard_pytree",
    "tp_rules_gpt",
]

Bounds = Tuple[Tuple[int, int], ...]


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a layout: None (the dimension is not
    split), an axis name, or a tuple of axis names (split over their
    product, the first the major). A tuple, so it compares and indexes as
    the reference's does (``spec[0] == "tensor"``, ``P("fsdp", None) ==
    P("fsdp", None)``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _same_mesh(a, b) -> bool:
    return a is b or (
        tuple(a.axis_names) == tuple(b.axis_names)
        and a.devices.shape == b.devices.shape
        and list(a.devices.flat) == list(b.devices.flat))


class NamedSharding:
    """A layout: ``spec`` over ``mesh``'s axes. Equal to another when the
    meshes hold the same devices under the same axes and the specs are
    equal."""

    def __init__(self, mesh, spec: Sequence = ()) -> None:
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        for entry in self.spec:
            for a in _axes(entry):
                if a not in mesh.shape:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                     f"not in the mesh {mesh.shape}")

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.spec == other.spec
                and _same_mesh(self.mesh, other.mesh))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def position_bounds(self, shape: Sequence[int]) -> List[Bounds]:
        """The global bounds each mesh position holds, in the mesh's
        row-major order: the reference's ``_normalize_index`` of each
        device's shard index. A split dimension must divide evenly."""
        shape = tuple(int(d) for d in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"the {len(shape)}-d shape {shape}")
        mshape = self.mesh.shape
        grid = self.mesh.devices.shape
        names = self.mesh.axis_names
        out = []
        for pos in range(self.mesh.size):
            coord = dict(zip(names, np.unravel_index(pos, grid)))
            bounds = []
            for i, dim in enumerate(shape):
                axes = _axes(self.spec[i]) if i < len(self.spec) else ()
                n, idx = 1, 0
                for a in axes:
                    n *= mshape[a]
                    idx = idx * mshape[a] + int(coord[a])
                if dim % n:
                    raise ValueError(f"dimension {i} of {shape} does not "
                                     f"split over {axes} ({n} shards)")
                block = dim // n
                bounds.append((idx * block, (idx + 1) * block))
            out.append(tuple(bounds))
        return out


def _device(d) -> torch.device:
    """``d`` as the device a tensor placed there reports (``cuda`` names
    the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _layout(shape, sharding: NamedSharding
            ) -> Tuple[List[Bounds], List[torch.device], List[int]]:
    """Distinct (bounds, device) pairs of a layout in row-major order of
    their first position, and each position's index into them."""
    bounds, devices, index = [], [], []
    seen: Dict[tuple, int] = {}
    for pos, b in enumerate(sharding.position_bounds(shape)):
        dev = _device(sharding.mesh.devices.flat[pos])
        key = (b, str(dev))
        if key not in seen:
            seen[key] = len(bounds)
            bounds.append(b)
            devices.append(dev)
        index.append(seen[key])
    return bounds, devices, index


def _slices(bounds: Bounds) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in bounds)


class ShardedTensor:
    """One leaf held in a sharded layout: its global ``shape``, ``dtype``
    and ``sharding``, and ``pieces``, one tensor per distinct (global
    bounds, device) pair of the layout (``bounds[i]``, ``devices[i]``), in
    row-major order of the mesh position that first holds it. A leaf of
    the heal plane (``utils.serialization`` flattens it as one leaf, as
    the reference flattens a sharded ``jax.Array``)."""

    def __init__(self, shape: Sequence[int], dtype: torch.dtype,
                 sharding: NamedSharding,
                 pieces: Sequence[torch.Tensor]) -> None:
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.bounds, self.devices, self._index = _layout(self.shape,
                                                         sharding)
        if len(pieces) != len(self.bounds):
            raise ValueError(f"{len(pieces)} pieces for a layout of "
                             f"{len(self.bounds)}")
        for p, b, dev in zip(pieces, self.bounds, self.devices):
            want = tuple(hi - lo for lo, hi in b)
            # a CPU tensor reports no index: "cpu:1" holds a "cpu" tensor
            if tuple(p.shape) != want or p.dtype != dtype \
                    or p.device != dev and not (
                        p.device.type == dev.type == "cpu"):
                raise ValueError(
                    f"piece {tuple(p.shape)} {p.dtype} on {p.device}, the "
                    f"layout wants {want} {dtype} on {dev}")
        self.pieces = list(pieces)

    @classmethod
    def from_full(cls, full: Any, sharding: NamedSharding,
                  dtype: Optional[torch.dtype] = None) -> "ShardedTensor":
        """Cut a whole leaf (a torch tensor or a numpy array) into the
        layout's pieces, each copied to its device."""
        if not isinstance(full, torch.Tensor):
            full = torch.from_numpy(np.require(full, requirements=["C", "W"]))
        dtype = full.dtype if dtype is None else dtype
        bounds, devices, _ = _layout(full.shape, sharding)
        pieces = [full[_slices(b)].to(device=d, dtype=dtype, copy=True)
                  .contiguous() for b, d in zip(bounds, devices)]
        return cls(full.shape, dtype, sharding, pieces)

    def like(self, pieces: Sequence[torch.Tensor]) -> "ShardedTensor":
        """The same layout over other pieces."""
        return ShardedTensor(self.shape, self.dtype, self.sharding, pieces)

    def piece_at(self, position: int) -> torch.Tensor:
        """The piece mesh position ``position`` (row-major) holds."""
        return self.pieces[self._index[position]]

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) \
            * torch.empty((), dtype=self.dtype).element_size()

    def full(self, device: "Optional[str | torch.device]" = None
             ) -> torch.Tensor:
        """The whole leaf, assembled on ``device`` (default: the first
        piece's)."""
        device = self.devices[0] if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for p, b in zip(self.pieces, self.bounds):
            if b not in done:
                out[_slices(b)] = p.detach().to(device)
                done.add(b)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, pieces={len(self.pieces)})")


register_tensor_leaf(ShardedTensor)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def _largest_divisible_dim(shape: Sequence[int], size: int,
                           exclude: Sequence[int] = ()) -> Optional[int]:
    best = None
    for i, d in enumerate(shape):
        if i in exclude:
            continue
        if d % size == 0 and (best is None or d > shape[best]):
            best = i
    return best


def fsdp_sharding(mesh, shape: Sequence[int], dtype=None,
                  axis: str = "fsdp",
                  pspec_so_far: Optional[List[Optional[str]]] = None
                  ) -> NamedSharding:
    """Shard ``shape``'s largest divisible dimension over ``axis``; a
    shape with none (or 0-d) stays replicated. ``pspec_so_far`` keeps the
    dimensions tensor parallelism took (the HSDP composition)."""
    del dtype
    if axis not in mesh.shape:
        return replicated(mesh)
    size = mesh.shape[axis]
    spec: List[Optional[Any]] = (
        list(pspec_so_far) if pspec_so_far is not None
        else [None] * len(shape)
    )
    taken = [i for i, s in enumerate(spec) if s is not None]
    dim = _largest_divisible_dim(shape, size, exclude=taken)
    if dim is None or len(shape) == 0:
        return NamedSharding(mesh, PartitionSpec(*spec))
    spec[dim] = axis
    return NamedSharding(mesh, PartitionSpec(*spec))


# Each rule: (path regex, dim to shard on the tensor axis), None =
# replicate; an optional third element names the mesh axis it shards on.
TpRule = Union[
    Tuple[str, Optional[int]],
    Tuple[str, Optional[int], str],
]


def tp_rules_gpt() -> List[TpRule]:
    """Megatron's layout for the GPT family (models/transformer.py):
    column-parallel QKV and MLP-up (output dim), row-parallel attn-out and
    MLP-down (input dim), embeddings and the lm head on the vocabulary."""
    return [
        (r".*attn.*(q_proj|k_proj|v_proj|qkv).*kernel", 1),   # column
        (r".*attn.*(o_proj|out_proj).*kernel", 0),            # row
        (r".*mlp.*(up_proj|gate_proj|fc1).*kernel", 1),       # column
        (r".*mlp.*(down_proj|fc2).*kernel", 0),               # row
        (r".*wpe.*", None),             # positional table: replicate
        (r".*(wte|tok_embed).*", 0),    # token embeddings: vocab shard
        (r".*lm_head.*kernel", 1),                            # vocab out
        (r".*bias", None),
        (r".*(ln|layernorm|norm|scale).*", None),
    ]


def _path_str(path) -> str:
    """A leaf's path in the reference's form, ``layers_0/attn/q_proj/
    kernel``: a string as it is, else its keys (dict keys, attribute
    names, list indices) joined by "/"."""
    if isinstance(path, str):
        return path
    parts = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                p = getattr(p, attr)
                break
        parts.append(str(p))
    return "/".join(parts)


def make_sharding_fn(
    mesh,
    tp_rules: Optional[List[TpRule]] = None,
    fsdp_axis: Optional[str] = "fsdp",
    tensor_axis: str = "tensor",
) -> Callable:
    """``fn(path, leaf) -> NamedSharding``: the first TP rule matching the
    path, then FSDP over the dimensions it left (the HSDP in-group
    composition)."""
    have_fsdp = fsdp_axis is not None and fsdp_axis in mesh.shape and (
        mesh.shape[fsdp_axis] > 1
    )

    def _fn(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        spec: List[Optional[str]] = [None] * len(shape)
        if tp_rules:
            name = _path_str(path)
            for rule in tp_rules:
                pattern, dim = rule[0], rule[1]
                axis = rule[2] if len(rule) > 2 else tensor_axis
                if re.fullmatch(pattern, name):
                    if (
                        dim is not None
                        and axis in mesh.shape
                        and mesh.shape[axis] > 1
                        and dim < len(shape)
                        and shape[dim] % mesh.shape[axis] == 0
                    ):
                        spec[dim] = axis
                    break
        if have_fsdp:
            return fsdp_sharding(
                mesh, shape, axis=fsdp_axis, pspec_so_far=spec
            )
        return NamedSharding(mesh, PartitionSpec(*spec))

    return _fn


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return type(tree)((k, _map_with_path(fn, v, path + (k,)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def shard_pytree(params: Any, mesh, tp_rules: Optional[List[TpRule]] = None,
                 fsdp_axis: Optional[str] = "fsdp",
                 tensor_axis: str = "tensor") -> Any:
    """Every leaf (a torch tensor or a numpy array, in nested dicts and
    lists) cut into a :class:`ShardedTensor` of its computed layout."""
    fn = make_sharding_fn(mesh, tp_rules, fsdp_axis, tensor_axis)
    return _map_with_path(
        lambda path, leaf: ShardedTensor.from_full(leaf, fn(path, leaf)),
        params)
