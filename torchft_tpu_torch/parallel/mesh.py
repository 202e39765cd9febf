"""Fault-tolerant device mesh: a static in-group mesh and the quorum's
replica axis.

Twin of ``torchft_tpu/parallel/mesh.py``. The in-group mesh is the port's
own small :class:`Mesh`: axis names, their sizes and an object array of
``torch.device`` s. A device may appear at several coordinates: a mesh of
``[torch.device("cuda")] * 4`` is a *virtual* mesh on one card, the port's
counterpart of the reference's ``--xla_force_host_platform_device_count``
CPU devices. The shards of an axis then run in lock-step in one process
(``parallel/ring.py``), each on its coordinate's device.

The replica axis never appears in the in-group mesh: its size is the live
participant count of the Manager's quorum, which :class:`FTMesh` pairs
with the static mesh (the reference's ``ManagedDeviceMesh`` analog).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["AXIS_DATA", "AXIS_EXPERT", "AXIS_FSDP", "AXIS_SEQ",
           "AXIS_TENSOR", "FTMesh", "Mesh", "REPLICA_AXIS", "ft_mesh"]

AXIS_DATA = "data"      # in-group data parallel (batch)
AXIS_FSDP = "fsdp"      # in-group parameter sharding
AXIS_TENSOR = "tensor"  # tensor parallel (per-layer sharding)
AXIS_SEQ = "seq"        # sequence / context parallel (ring attention)
AXIS_EXPERT = "expert"  # expert parallel (MoE)

REPLICA_AXIS = "replica"


class Mesh:
    """An in-group device mesh: ``axis_names``, ``shape`` (axis name ->
    size, in axis order) and ``devices``, an object array of
    ``torch.device`` s of that shape."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis_name: str) -> list:
        """The devices along ``axis_name``, the other axes at index 0: the
        shards of that axis, in order."""
        i = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        devices = sorted(set(map(str, self.devices.flat)))
        return f"Mesh({self.shape}, devices={devices})"


def _visible_cards() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass devices=['cpu'] "
                           "* n for a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def ft_mesh(axes: Dict[str, int],
            devices: Optional[Sequence[Union[str, torch.device]]] = None
            ) -> Mesh:
    """Build the in-group mesh over this replica group's devices.

    ``axes`` maps axis name -> size, e.g. ``{"data": 2, "fsdp": 4}``. Sizes
    must multiply to the device count (use -1 for one axis to infer it).
    ``devices`` defaults to the visible CUDA cards; a list that repeats a
    device (``[torch.device("cuda")] * 4``, ``["cpu"] * 4``) gives a
    virtual mesh. The replica axis is deliberately not an argument (see
    :class:`FTMesh`)."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else _visible_cards())]
    names = list(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = 1
    for s in sizes:
        if s != -1:
            known *= s
    if -1 in sizes:
        if len(devices) % known != 0:
            raise ValueError(
                f"cannot infer axis: {len(devices)} devices not divisible "
                f"by {known}"
            )
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} need {total} devices, "
            f"have {len(devices)}"
        )
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(sizes), names)


class FTMesh:
    """Static in-group mesh + dynamic (quorum-driven) replica dimension,
    with the reference's composition surface:

    - ``shape`` / ``size()`` / ``ndim`` include the virtual replica axis;
      its size is the live participant count, reported >= 1 even with
      zero participants.
    - ``ftmesh[names]`` returns an FTMesh view when the replica axis is
      selected, else the axis name (or name tuple) to use directly.
    - ``get_comm(axis)``: the replica axis resolves to a
      ``ManagedCommContext`` over the Manager; an in-group axis to its
      name (its shards run in lock-step in this process).
    - ``flattened_spec(*names)``: the axis names one array dimension is
      split over.
    - ``coordinate(device=None, index=None)``: per-axis indices including
      the replica rank.
    """

    def __init__(self, manager, mesh: Optional[Mesh],
                 replica_axis: str = REPLICA_AXIS,
                 selected: Optional[Tuple[str, ...]] = None) -> None:
        """``selected``: restrict the view to these in-group axes (set by
        __getitem__); None = all of the mesh's axes."""
        self.manager = manager
        self.mesh = mesh
        self.replica_axis = replica_axis
        if mesh is not None and replica_axis in mesh.axis_names:
            raise ValueError(
                f"in-group mesh must not contain the virtual replica "
                f"axis {replica_axis!r}"
            )
        if selected is not None:
            for n in selected:
                if mesh is None or n not in mesh.axis_names:
                    raise KeyError(f"unknown mesh axis {n!r}")
        self._selected = selected

    # ------------------------------------------------------------ axis info

    def _in_group_names(self) -> Tuple[str, ...]:
        if self._selected is not None:
            return self._selected
        return tuple(self.mesh.axis_names) if self.mesh is not None else ()

    def _check_in_group_axis(self, name: str) -> None:
        if name not in self._in_group_names():
            raise KeyError(
                f"unknown mesh axis {name!r} (have "
                f"{(self.replica_axis,) + self._in_group_names()})"
            )

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.replica_axis,) + self._in_group_names()

    def axis_size(self, name: str) -> int:
        if name == self.replica_axis:
            return self.num_replicas()
        self._check_in_group_axis(name)
        return self.mesh.shape[name]

    @property
    def shape(self) -> Dict[str, int]:
        out = {self.replica_axis: self.num_replicas()}
        for n in self._in_group_names():
            out[n] = self.mesh.shape[n]
        return out

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    def size(self, name: Optional[str] = None) -> int:
        if name is not None:
            return self.axis_size(name)
        total = 1
        for s in self.shape.values():
            total *= s
        return total

    def num_replicas(self) -> int:
        """Size of the virtual replica axis = current quorum participants,
        reported as >= 1 even with zero participants."""
        return max(1, self.manager.num_participants())

    def global_batch_ratio(self) -> float:
        """Multiplier for metrics: how many replica-group batches commit
        per step right now."""
        return float(self.num_replicas())

    # ----------------------------------------------------------- selection

    def __getitem__(self, names):
        """Selecting the replica axis yields an FTMesh view restricted to
        the selected in-group axes; selecting only in-group axes yields the
        name (or the name tuple)."""
        if isinstance(names, str):
            names = (names,)
        for n in names:
            if n != self.replica_axis:
                self._check_in_group_axis(n)
        if self.replica_axis in names:
            rest = tuple(n for n in names if n != self.replica_axis)
            return FTMesh(
                self.manager,
                self.mesh if rest else None,
                replica_axis=self.replica_axis,
                selected=rest if rest else None,
            )
        return names if len(names) > 1 else names[0]

    def get_comm(self, axis: Optional[str] = None):
        """What moves data across ``axis``: the replica axis (or None) -> a
        ``ManagedCommContext`` routing through the Manager; an in-group
        axis -> its name."""
        if axis is None or axis == self.replica_axis:
            from torchft_tpu_torch.comm.context import ManagedCommContext

            return ManagedCommContext(self.manager)
        self._check_in_group_axis(axis)
        return axis

    def flattened_spec(self, *names: str) -> Tuple[str, ...]:
        """The in-group axes one array dimension is split over, in order;
        the replica axis cannot be one of them."""
        for n in names:
            if n == self.replica_axis:
                raise ValueError(
                    "the replica axis is virtual and cannot shard an array "
                    "dimension (it never exists in the in-group mesh)"
                )
            self._check_in_group_axis(n)
        return tuple(names)

    def coordinate(self, device: Optional[Union[str, torch.device]] = None,
                   index: Optional[int] = None) -> Dict[str, int]:
        """Per-axis indices of a mesh position, plus this replica group's
        rank on the virtual axis. The position is ``index`` (flat, in the
        mesh's row-major order) or the one holding ``device``; with
        neither, the first. On a virtual mesh a device sits at several
        positions: asking by such a device raises ValueError, ask by
        ``index``."""
        rank = self.manager.participating_rank()
        out = {self.replica_axis: rank if rank is not None else 0}
        if self.mesh is None:
            return out
        devs = self.mesh.devices
        if device is not None and index is not None:
            raise ValueError("pass device or index, not both")
        if device is not None:
            device = torch.device(device)
            hits = [i for i, d in enumerate(devs.flat) if d == device]
            if not hits:
                raise ValueError(f"{device} is not part of the in-group mesh")
            if len(hits) > 1:
                raise ValueError(
                    f"{device} sits at {len(hits)} positions of a virtual "
                    f"mesh (flat indices {hits}); pass index= instead")
            index = hits[0]
        index = 0 if index is None else int(index)
        if not 0 <= index < devs.size:
            raise ValueError(f"index {index} outside a mesh of {devs.size}")
        selected = self._in_group_names()
        for name, i in zip(self.mesh.axis_names,
                           np.unravel_index(index, devs.shape)):
            if name in selected:
                out[name] = int(i)
        return out

    def __repr__(self) -> str:
        inner = {n: self.mesh.shape[n] for n in self._in_group_names()}
        return (
            f"FTMesh(in_group={inner}, "
            f"replicas~{self.num_replicas()})"
        )
