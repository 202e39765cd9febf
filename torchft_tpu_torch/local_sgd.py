"""Fault-tolerant LocalSGD and DiLoCo with a streaming fragment scheduler.

Twin of ``torchft_tpu/local_sgd.py`` over torch parameters. Replica groups
train locally for ``sync_every`` inner optimizer steps between
cross-replica syncs, keep a host backup of the parameters to roll a failed
sync back, and decide commit once per sync round:

    local = DiLoCo(manager, sgd(0.7, momentum=0.9, nesterov=True),
                   sync_every=8, num_fragments=2)
    local.register(model)              # nn.Module or a list of tensors
    for batch in data:
        train_step(*batch)             # forward, backward, optimizer.step()
        local.step()                   # the round machinery, in place

The parameters are updated in place (``copy_`` into the same storages), so
a CUDA graph captured over them (``models.make_train_step``) stays valid
through commits, rollbacks and heals.

Streaming fragment scheduler: the parameter leaves are cut into
``num_fragments`` byte-balanced contiguous fragments
(``comm.wire.split_weighted``, a function of the shapes alone, so every
rank computes the same grid), and fragment ``f`` ships at inner step
``sync_every*(f+1)//num_fragments`` of the round. At its boundary a
fragment

1. copies its leaves from the card into a persistent f32 host arena (pinned
   on CUDA; a non-blocking copy on a side stream that waits on the training
   stream, synchronized by one event): the parameters themselves for
   LocalSGD, the pseudogradient ``backup - params`` for DiLoCo (the
   paper's sign, which the reference uses);
2. with error feedback on, adds its residual and computes the next one
   against the wire codec on a bounded worker (residuals reset whenever the
   transport's incarnation changes);
3. rides ``manager.allreduce_arrays`` as a non-blocking op while the inner
   loop keeps stepping, the arena donated to the wire; and
4. lands on a bounded worker the moment its wire future resolves: the
   average itself for LocalSGD, a per-fragment outer optimizer step
   (``optim.PartitionedOuterOptimizer``) from the backup for DiLoCo. The
   landing is STAGED on the host and touches no device.

The quorum is started one inner step ahead of the first boundary (at it,
with a sync-quorum manager) and fenced at the first boundary
(``Manager.quorum_fence``, which also applies a pending heal, after which
the round re-reads ``params_fn`` and snapshots the healed tensors). A
``futures.FutureGroup`` resolves the round once every fragment has landed
and every error-feedback task has finished; ``should_commit`` gates the
whole round; an aborted round writes every fragment back from its backup,
landed ones included. Staged updates are never merged before the vote.

``streaming=False`` keeps the schedule and the arithmetic but blocks at
every boundary: the A/B arm and the bitwise oracle.

Metrics (``manager.metrics``): per-fragment ``outer_d2h`` / ``outer_ef`` /
``outer_wire`` / ``outer_land`` timers, and per-round gauges
``outer_wire_ms`` (summed fragment wire time), ``outer_wire_exposed_ms``
(the time the round blocked on the wire), ``outer_overlap`` (1 - exposed /
total), ``outer_wire_bytes`` (encoded payload bytes) and
``outer_inflight_at_drain`` (fragments still on the wire when the round ran
out of inner steps).

``topology`` ("flat"/"hier", None = the comm context's default) is
forwarded to every fragment's allreduce: the hierarchical tier carries the
pseudogradients across domains encoded once per domain.

``sharded_outer=True`` makes the fragments the shard unit of the outer
update. Fragment ``f`` is owned by wire rank ``f % world`` (the membership
read at the round's fence): its value reduce-scatters to the owner alone,
only the owner lands it (and, for DiLoCo, holds its outer state), and a
committed round allgathers the owners' updated fragments in their native
dtypes, so every rank commits the bits the replicated arm commits. When
the owner map changes (a shrink, a grow, a heal: ``wire_generation`` or
``(world, rank)`` moved), DiLoCo runs one exchange at the fence
(``checkpointing.redistribute_exchange`` over ``comm/redistribute.py``)
that moves each arriving fragment's outer state from a live holder; only a
fragment no live rank holds is reinitialized, counted in the ``reshard``
event's ``reinit_fragments``.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from torchft_tpu_torch.comm.wire import split_weighted
from torchft_tpu_torch.ddp import _ef_gate
from torchft_tpu_torch.futures import FutureGroup
from torchft_tpu_torch.optim import (
    OuterTransformation,
    PartitionedOuterOptimizer,
    from_optax_state,
)
from torchft_tpu_torch.utils.profiling import timed_span
from torchft_tpu_torch.utils.serialization import (
    tree_flatten_with_path,
    tree_unflatten,
)

logger = logging.getLogger(__name__)

__all__ = ["DiLoCo", "LocalSGD", "fragment_boundaries", "from_jax_state"]


def fragment_boundaries(sync_every: int, num_fragments: int) -> List[int]:
    """Inner-step boundary of each fragment: fragment ``f`` ships at step
    ``sync_every*(f+1)//num_fragments`` of the round, the last exactly at
    the round's end. Strictly increasing whenever ``sync_every >=
    num_fragments`` (the constructor enforces it)."""
    return [
        sync_every * (f + 1) // num_fragments for f in range(num_fragments)
    ]


# Process-wide bounded workers for the outer stages, shared by every
# wrapper in the process (groups run as threads). Landings ("land") and
# error-feedback codec roundtrips ("ef") get separate pools, so a large
# quantizer task never queues a landing whose wire future has resolved.
# Tasks never wait on other tasks, so the bounded pools cannot deadlock.
_OUTER_LOCK = threading.Lock()
_OUTER_EXECUTORS: "Dict[str, ThreadPoolExecutor]" = {}


def _outer_executor(kind: str) -> ThreadPoolExecutor:
    with _OUTER_LOCK:
        ex = _OUTER_EXECUTORS.get(kind)
        if ex is None:
            ex = ThreadPoolExecutor(
                max_workers=2,
                thread_name_prefix=f"torchft_tpu_torch_outer_{kind}",
            )
            _OUTER_EXECUTORS[kind] = ex
        return ex


_REMOTE = object()  # staged-slot sentinel: the fragment landed on its owner


class _SyncRound:
    """One in-flight sync round: the completion group, the per-fragment
    staged landings (adopted only on commit), the wire timestamps the
    overlap gauges come from, and the wire membership read at the fence
    (the sharded outer update's owner map, fragment ``f`` on rank
    ``f % world``, derives from it)."""

    __slots__ = ("group", "staged", "shipped", "fenced", "submit_t",
                 "wire_t", "exposed_s", "wire_bytes", "world", "rank")

    def __init__(self, num_fragments: int) -> None:
        self.group = FutureGroup()
        self.staged: List[Any] = [None] * num_fragments
        self.shipped = [False] * num_fragments
        self.fenced = False
        self.submit_t = [0.0] * num_fragments
        self.wire_t = [0.0] * num_fragments
        self.exposed_s = 0.0
        self.wire_bytes = 0
        self.world = 1
        self.rank = 0


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """A host leaf as a wire array in its own dtype; a dtype numpy lacks
    (bfloat16, the float8 types) rides as its bits, an integer of its
    width."""
    t = t.detach().contiguous()
    try:
        return t.numpy()
    except TypeError:
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[t.element_size()]
        return t.view(bits).numpy()


def _from_wire(a: np.ndarray, dtype: torch.dtype,
               shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`_to_wire` (a 0-d array may arrive as shape (1,))."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype != dtype:
        t = t.view(dtype)
    return t.reshape(shape)


def _param_list(params: Any) -> List[torch.Tensor]:
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return list(params)


def _host_tensor(x: Any) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


class LocalSGD:
    """Infrequent-sync data parallelism with rollback, scheduled as
    streaming fragments (module docstring). LocalSGD ships the parameters
    themselves; a committed round adopts the cross-replica average."""

    def __init__(self, manager, sync_every: int,
                 params_fn: Optional[Any] = None,
                 num_fragments: int = 1,
                 streaming: bool = True,
                 error_feedback: "bool | str" = "auto",
                 sharded_outer: bool = False,
                 topology: "Optional[str]" = None) -> None:
        """``params_fn``: zero-argument callable returning the current
        parameters (an ``nn.Module`` or a list of tensors), the state the
        Manager's user ``load_state_dict`` writes a heal into. After a heal
        at the round's fence the round re-reads it, so a load that
        replaced tensors is followed.

        ``num_fragments``: outer-sync fragments (1 = one monolithic sync at
        the round's end). ``streaming``: non-blocking staggered wire (True)
        or block at every boundary (the A/B arm). ``error_feedback``:
        "auto" keeps a residual exactly when this rank's contribution
        crosses a lossy codec (``manager.wire_compensable``); True forces
        it; False disables it. ``topology``: the data path of every
        fragment's allreduce ("flat"/"hier"; None passes no override).

        ``sharded_outer``: each fragment's value reduce-scatters to its
        owner (wire rank ``f % world``), only the owner lands it, and a
        committed round allgathers the owners' updated fragments (module
        docstring). It changes the collective sequence, so it must match
        across replica groups."""
        # passed only when set, so managers without the keyword work
        self._ar_kwargs = {} if topology is None else {"topology": topology}
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if num_fragments < 1:
            raise ValueError("num_fragments must be >= 1")
        if sync_every < num_fragments:
            raise ValueError(
                f"sync_every ({sync_every}) must be >= num_fragments "
                f"({num_fragments}): fragments ship at inner steps "
                f"sync_every*(f+1)//num_fragments, which collide when the "
                "round has fewer steps than fragments — raise sync_every "
                "or lower num_fragments"
            )
        if error_feedback not in (True, False, "auto"):
            raise ValueError(
                f"error_feedback must be True/False/'auto', "
                f"got {error_feedback!r}"
            )
        self._manager = manager
        self._sync_every = sync_every
        self._params_fn = params_fn
        self._num_fragments = int(num_fragments)
        self._streaming = bool(streaming)
        self._error_feedback = error_feedback
        self._sharded_outer = bool(sharded_outer)
        # the owner map of the last outer reshard, and the transport
        # incarnation it ran under: the cohort-synchronized trigger
        self._outer_world: Optional[Tuple[int, int]] = None
        self._outer_gen: Optional[int] = None
        self._local_step = 0
        self._healed_backup = False
        # the live parameters, and the layout frozen at register: the grid
        # must be identical across ranks and across rounds
        self._params: Optional[List[torch.Tensor]] = None
        self._shapes: Optional[List[Tuple[int, ...]]] = None
        self._dtypes: Optional[List[torch.dtype]] = None
        self._sizes: Optional[List[int]] = None
        self._fragments: Optional[List[Tuple[int, int]]] = None
        self._boundaries: Optional[List[int]] = None
        # persistent host arenas (pinned when the parameters are on CUDA)
        self._backup: Optional[List[torch.Tensor]] = None
        self._arena: Optional[List[torch.Tensor]] = None
        self._ef_residuals: Optional[List[np.ndarray]] = None
        self._ef_scratch: Optional[List[Optional[np.ndarray]]] = None
        self._ef_generation: Optional[int] = None
        self._d2h_stream = None
        self._round: Optional[_SyncRound] = None
        self._round_starting = False

    # -- introspection -------------------------------------------------------

    @property
    def local_step(self) -> int:
        return self._local_step

    @property
    def num_fragments(self) -> int:
        """Actual fragment count (clamped to the leaf count at register;
        the requested value before)."""
        if self._fragments is not None:
            return len(self._fragments)
        return self._num_fragments

    @property
    def streaming(self) -> bool:
        return self._streaming

    def _metrics(self):
        return getattr(self._manager, "metrics", None)

    def _wire_healthy(self) -> bool:
        """Gauge gate: after a latched error every allreduce resolves
        inline, and its ~0 ms wire time would corrupt the overlap gauges;
        skip the observations (the round does not commit anyway)."""
        errored = getattr(self._manager, "errored", None)
        return not callable(errored) or errored() is None

    # -- lifecycle -----------------------------------------------------------

    def register(self, params: Any) -> Any:
        """Freeze the leaf and fragment layout of ``params`` (an
        ``nn.Module`` or a list of tensors) and save the initial backup.
        Returns ``params``."""
        self._attach(_param_list(params))
        self._save_backup()
        return params

    def _attach(self, leaves: List[torch.Tensor]) -> None:
        if self._shapes is None:
            self._build_layout(leaves)
        else:
            self._check_layout(leaves)
        self._params = leaves

    def _build_layout(self, leaves: List[torch.Tensor]) -> None:
        self._shapes = [tuple(x.shape) for x in leaves]
        self._dtypes = [x.dtype for x in leaves]
        self._sizes = [int(x.numel()) for x in leaves]
        if any(not dt.is_floating_point for dt in self._dtypes):
            logger.warning(
                "parameters include integer leaves: the outer wire plane "
                "is float32, so integer values survive the sync exactly "
                "only below 2**24"
            )
        # byte-balanced fragments over the f32 wire plane's staged bytes
        self._fragments = split_weighted(
            [sz * 4 for sz in self._sizes], self._num_fragments
        )
        if len(self._fragments) != self._num_fragments:
            logger.info(
                "num_fragments clamped %d -> %d (%d leaves)",
                self._num_fragments, len(self._fragments), len(leaves),
            )
        self._boundaries = fragment_boundaries(
            self._sync_every, len(self._fragments)
        )
        pin = any(x.is_cuda for x in leaves)
        self._backup = [
            torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
            for x in leaves
        ]
        self._arena = [
            torch.empty(self._frag_elems(f), dtype=torch.float32,
                        pin_memory=pin)
            for f in range(len(self._fragments))
        ]

    def _check_layout(self, leaves: List[torch.Tensor]) -> None:
        if [tuple(x.shape) for x in leaves] != self._shapes:
            raise ValueError(
                "parameters changed shape or count since register(); the "
                "outer-sync fragment layout is frozen"
            )

    def _save_backup(self) -> None:
        with torch.no_grad():
            for dst, p in zip(self._backup, self._params):
                dst.copy_(p.detach())

    def _push_backup(self) -> None:
        """Write the backup into the live parameters, in place, on the
        training stream; wait for the copies, so the host may rewrite the
        backup at any later time."""
        device = None
        with torch.no_grad():
            for p, b in zip(self._params, self._backup):
                p.copy_(b, non_blocking=p.is_cuda)
                device = p.device if p.is_cuda else device
        if device is not None:
            torch.cuda.current_stream(device).synchronize()

    # -- checkpoint surface --------------------------------------------------
    # The backup is training state: a healing replica must receive the
    # donor's sync point, not re-derive one, or its first round diverges.
    # Put state_dict() in the state the Manager serves.

    def state_dict(self) -> dict:
        backup = None
        if self._backup is not None:
            # copies: the heal plane stages lazily, and a commit refreshing
            # the arena under a deferred read would serve a torn sync point
            backup = [torch.empty(b.shape, dtype=b.dtype).copy_(b)
                      for b in self._backup]
        return {"backup": backup, "local_step": self._local_step}

    def load_state_dict(self, state: dict) -> None:
        backup = state["backup"]
        if backup is not None:
            if self._backup is None:
                raise RuntimeError(
                    "load_state_dict before register(): the backup arena "
                    "takes the layout of the registered parameters"
                )
            if len(backup) != len(self._backup):
                raise ValueError(
                    f"donor backup has {len(backup)} leaves but this "
                    f"replica's frozen layout has {len(self._backup)}: "
                    "replica configs diverged — align model/wrapper "
                    "construction across replica groups"
                )
            for dst, src in zip(self._backup, backup):
                dst.copy_(_host_tensor(src).reshape(dst.shape))
        if self._round is None and not self._round_starting:
            # Mid-round (a heal at the fence, or inside a sync-quorum
            # manager's start_quorum) the schedule owns the counter: the
            # donor's describes its own position, and adopting it would
            # rewind this round's fragment schedule and strand the peers'
            # allreduces waiting for fragments that never ship.
            self._local_step = int(state["local_step"])
        self._healed_backup = True

    def restore(self) -> None:
        """Write the last committed (synced) parameters back into the live
        tensors."""
        assert self._backup is not None, "register() was never called"
        self._push_backup()

    # -- stepping ------------------------------------------------------------

    def _kick_step(self) -> int:
        """Inner step at which the round's quorum starts: one step ahead of
        the first boundary with an async-quorum manager, so the RPC
        overlaps inner compute; at the boundary itself with a sync-quorum
        manager, whose start_quorum blocks (and heals)."""
        b0 = self._boundaries[0]
        if getattr(self._manager, "_use_async_quorum", False):
            return max(1, b0 - 1)
        return b0

    def step(self) -> None:
        """Count one inner optimizer step and drive the round machinery
        (quorum kick, fence, fragment boundaries, commit) as it comes due."""
        if self._params is None:
            raise RuntimeError("register() the parameters before step()")
        self._local_step += 1
        if self._round is None and self._local_step >= self._kick_step():
            self._begin_round()
        if self._round is not None:
            self._advance_round(self._local_step)

    def sync(self, params: Any = None) -> None:
        """Force a full sync round now: every fragment ships this step and
        the round commits or rolls back before this returns. ``params``
        registers them first on a wrapper that was never registered."""
        if self._params is None:
            if params is None:
                raise RuntimeError("register() the parameters before sync()")
            self.register(params)
        self._local_step = max(self._local_step, self._sync_every)
        if self._round is None:
            self._begin_round()
        self._advance_round(self._local_step)

    def _begin_round(self) -> None:
        # a sync-quorum manager applies a pending heal inside start_quorum,
        # before self._round exists: the flag tells load_state_dict that
        # the schedule already owns _local_step
        self._round_starting = True
        try:
            self._manager.start_quorum()
        finally:
            self._round_starting = False
        self._round = _SyncRound(len(self._fragments))

    def _advance_round(self, s: int) -> None:
        rnd = self._round
        if not rnd.fenced and s >= self._boundaries[0]:
            rnd.fenced = True
            self._fence()
        for f, b in enumerate(self._boundaries):
            if not rnd.shipped[f] and b <= s:
                self._ship_fragment(rnd, f)
                rnd.shipped[f] = True
        if s >= self._sync_every:
            self._finish_round(rnd)

    def _fence(self) -> None:
        """Round-start fence: resolve the quorum kicked ahead of the first
        boundary and apply a pending heal, so every fragment snapshot of
        this round derives from healed state."""
        mgr = self._manager
        try:
            fence = getattr(mgr, "quorum_fence", None)
            if callable(fence):
                fence()
            else:
                mgr.wait_quorum()
        except Exception as e:  # noqa: BLE001 — latch; the round aborts
            # at its commit barrier instead of crashing the inner loop
            logger.exception("round-start quorum fence failed: %s", e)
            mgr.report_error(e)
            return
        if mgr.did_heal():
            # the fence applied a peer's checkpoint through the user's
            # load_state_dict: snapshot THAT state from here on
            if self._params_fn is not None:
                self._attach(_param_list(self._params_fn()))
                if self._healed_backup:
                    # the donor's backup came through load_state_dict: it
                    # is the true sync point
                    self._healed_backup = False
                else:
                    self._save_backup()
            else:
                logger.warning(
                    "healed without params_fn: the round reads the "
                    "registered tensors, which a load that replaced them "
                    "leaves stale — pass params_fn to LocalSGD/DiLoCo"
                )
        rnd = self._round
        if rnd is not None:
            world_fn = getattr(mgr, "transport_world_size", None)
            rank_fn = getattr(mgr, "transport_rank", None)
            rnd.world = max(1, int(world_fn()) if callable(world_fn) else 1)
            rnd.rank = int(rank_fn()) if callable(rank_fn) else 0
            if self._sharded_outer:
                self._on_owner_map(rnd)

    # -- the sharded outer update --------------------------------------------

    def _frag_owner(self, rnd: _SyncRound, f: int) -> int:
        return f % rnd.world

    def _frag_owned(self, rnd: _SyncRound, f: int) -> bool:
        return (not self._sharded_outer or rnd.world == 1
                or self._frag_owner(rnd, f) == rnd.rank)

    def _on_owner_map(self, rnd: _SyncRound) -> None:
        """Called at every fence of a sharded round, once the wire
        membership is known: DiLoCo moves its per-fragment outer states
        onto the new owner map. LocalSGD holds no outer state."""

    def _exchange_fragments(self, rnd: _SyncRound,
                            contrib: Dict[int, List[np.ndarray]]
                            ) -> Dict[int, List[np.ndarray]]:
        """The commit's allgather of updated fragments: each rank
        contributes its owned fragments' leaves (native dtypes, raw bytes)
        and receives every other owner's. Returns the wire arrays of EVERY
        fragment. It runs only on a committed round, a decision every rank
        shares, so the collective is matched; a failure here means this
        rank cannot build a round the cohort committed, so it raises and
        the group restarts and heals."""
        flat: List[np.ndarray] = []
        for f in sorted(contrib):
            flat.extend(contrib[f])
        mgr = self._manager
        gathered = mgr.allgather_arrays(flat).future().result()
        errored = getattr(mgr, "errored", None)
        if callable(errored) and errored() is not None:
            raise RuntimeError(
                "sharded outer round committed but the fragment allgather "
                f"failed ({errored()}): restart and heal")
        out: Dict[int, List[np.ndarray]] = {}
        for owner in range(rnd.world):
            arrays = gathered[owner] if owner < len(gathered) else []
            cursor = 0
            for f in range(len(self._fragments)):
                if self._frag_owner(rnd, f) != owner:
                    continue
                start, stop = self._fragments[f]
                got = arrays[cursor:cursor + stop - start]
                cursor += stop - start
                if len(got) != stop - start:
                    raise RuntimeError(
                        f"sharded outer commit: owner {owner} shipped "
                        f"{len(got)} of {stop - start} leaves of fragment "
                        f"{f}: restart and heal")
                out[f] = [np.asarray(a) for a in got]
        return out

    def _frag_native_leaves(self, f: int,
                            flat: np.ndarray) -> List[torch.Tensor]:
        """Fragment ``f``'s averaged f32 values as leaves in their native
        dtypes, converted as the replicated commit's ``copy_`` converts
        them (integers rounded, not truncated: exact below 2**24)."""
        start, stop = self._fragments[f]
        src = torch.from_numpy(flat)
        out: List[torch.Tensor] = []
        off = 0
        for i in range(start, stop):
            n = self._sizes[i]
            view = src[off:off + n].view(self._shapes[i])
            if not self._dtypes[i].is_floating_point:
                view = torch.round(view)
            out.append(view.to(self._dtypes[i]))
            off += n
        return out

    def _adopt_gathered(self, rnd: _SyncRound,
                        contrib: Dict[int, List[torch.Tensor]]) -> None:
        """Allgather the owned fragments' new leaves, write every
        fragment's into the backup arena and from there into the live
        parameters, in place."""
        gathered = self._exchange_fragments(
            rnd, {f: [_to_wire(t) for t in leaves]
                  for f, leaves in contrib.items()})
        with torch.no_grad():
            for f, (start, stop) in enumerate(self._fragments):
                for a, i in zip(gathered[f], range(start, stop)):
                    self._backup[i].copy_(_from_wire(
                        a, self._dtypes[i], self._shapes[i]))
        self._push_backup()

    # -- fragment pipeline ---------------------------------------------------

    def _frag_elems(self, f: int) -> int:
        start, stop = self._fragments[f]
        return sum(self._sizes[start:stop])

    def _snapshot_into(self, f: int, out: torch.Tensor) -> None:
        """Copy fragment ``f``'s live leaves into ``out`` (its f32 arena).
        From the card: non-blocking copies into the pinned arena on a side
        stream that waits on the training stream, then one event wait;
        nothing else of the device is synchronized."""
        start, stop = self._fragments[f]
        leaves = self._params[start:stop]
        cuda = [p for p in leaves if p.is_cuda]
        if cuda:
            device = cuda[0].device
            if self._d2h_stream is None:
                self._d2h_stream = torch.cuda.Stream(device)
            side = self._d2h_stream
            side.wait_stream(torch.cuda.current_stream(device))
        off = 0
        with torch.no_grad():
            if cuda:
                with torch.cuda.stream(side):
                    for p in leaves:
                        n = p.numel()
                        out[off:off + n].copy_(p.detach().reshape(-1),
                                               non_blocking=True)
                        off += n
                    done = torch.cuda.Event()
                    done.record(side)
                done.synchronize()
            else:
                for p in leaves:
                    n = p.numel()
                    out[off:off + n].copy_(p.detach().reshape(-1))
                    off += n

    def _fragment_value_into(self, f: int, out: torch.Tensor) -> None:
        """LocalSGD ships the parameters themselves (weight averaging)."""
        self._snapshot_into(f, out)

    def _ef_prepare(self) -> None:
        """(Re)allocate zeroed residuals on first use and whenever the
        transport's incarnation changed: the previous round's quantization
        error no longer belongs to this cohort's stream."""
        gen_fn = getattr(self._manager, "wire_generation", None)
        gen = int(gen_fn()) if callable(gen_fn) else 0
        if self._ef_residuals is None or gen != self._ef_generation:
            self._ef_residuals = [
                np.zeros(self._frag_elems(f), np.float32)
                for f in range(len(self._fragments))
            ]
            self._ef_generation = gen

    def _ef_scratch_for(self, f: int) -> np.ndarray:
        if self._ef_scratch is None:
            self._ef_scratch = [None] * len(self._fragments)
        if self._ef_scratch[f] is None:
            self._ef_scratch[f] = np.empty(self._frag_elems(f), np.float32)
        return self._ef_scratch[f]

    def _ef_residual(self, transmitted: np.ndarray, res: np.ndarray,
                     metrics) -> None:
        """e = v' - C(v') against the wire's own chunk grid; ``transmitted``
        is v' (or a snapshot of it: the donated arena is reduced in place
        once the wire takes it)."""
        with timed_span(metrics, "outer_ef"):
            self._manager.wire_roundtrip(transmitted, res)  # res = C(v')
            np.subtract(transmitted, res, out=res)
            if not np.all(np.isfinite(res)):
                # a non-finite value is discarded by the commit gate, but a
                # NaN residual would re-inject it every later round
                np.nan_to_num(res, copy=False,
                              nan=0.0, posinf=0.0, neginf=0.0)

    def _ship_fragment(self, rnd: _SyncRound, f: int) -> None:
        mgr = self._manager
        metrics = self._metrics()
        arena_t = self._arena[f]
        with timed_span(metrics, "outer_d2h", span=f"outer_pack_frag{f}"):
            self._fragment_value_into(f, arena_t)
        arena = arena_t.numpy()
        if _ef_gate(mgr, self._error_feedback):
            self._ef_prepare()
            res = self._ef_residuals[f]
            # v' = v + e stays inline; the codec roundtrip rides the worker
            # when streaming, on a snapshot (the donated arena is reduced in
            # place once the wire takes it). Blocking computes it inline
            # before the submit: the same values, which keeps the two arms
            # bitwise.
            np.add(arena, res, out=arena)
            if self._streaming:
                scratch = self._ef_scratch_for(f)
                np.copyto(scratch, arena)
                rnd.group.add(_outer_executor("ef").submit(
                    self._ef_residual, scratch, res, metrics
                ))
            else:
                self._ef_residual(arena, res, metrics)
        nbytes_fn = getattr(mgr, "wire_nbytes", None)
        if callable(nbytes_fn):
            rnd.wire_bytes += int(nbytes_fn(arena))
        rnd.submit_t[f] = time.perf_counter()
        owned = self._frag_owned(rnd, f)
        if self._sharded_outer and rnd.world > 1:
            # the fragment is the shard unit: its average reaches its owner
            # alone (the bytes the allreduce would give there); the others
            # skip the landing and receive the owner's update at commit
            work = mgr.reduce_scatter_arrays(
                [arena], owners=[self._frag_owner(rnd, f)])
        else:
            work = mgr.allreduce_arrays([arena], **self._ar_kwargs)
        landed: Future = Future()
        landed.set_running_or_notify_cancel()
        rnd.group.add(landed)

        def _land(wf: Future, f: int = f, owned: bool = owned) -> None:
            try:
                reduced = wf.result()[0]
                if owned:
                    self._land_fragment(rnd, f, reduced)
                else:
                    rnd.staged[f] = _REMOTE
                landed.set_result(None)
            except Exception as e:  # noqa: BLE001 — fails the group, and
                landed.set_exception(e)  # the round aborts at its commit

        if self._streaming:
            def _on_wire(wf: Future, f: int = f) -> None:
                # wire-thread continuation: timestamp and enqueue only; the
                # landing belongs on the bounded worker
                rnd.wire_t[f] = time.perf_counter()
                if metrics is not None and self._wire_healthy():
                    metrics.observe(
                        "outer_wire", rnd.wire_t[f] - rnd.submit_t[f]
                    )
                _outer_executor("land").submit(_land, wf)

            work.add_done_callback(_on_wire)
        else:
            t0 = time.perf_counter()
            wf = work.future()
            try:
                wf.result()  # the Manager's futures never raise; a stub's
            except Exception:  # noqa: BLE001 — may: _land re-reads it
                pass
            rnd.wire_t[f] = time.perf_counter()
            rnd.exposed_s += rnd.wire_t[f] - t0
            if metrics is not None and self._wire_healthy():
                metrics.observe("outer_wire", rnd.wire_t[f] - rnd.submit_t[f])
            _land(wf)

    def _land_fragment(self, rnd: _SyncRound, f: int,
                       reduced: np.ndarray) -> None:
        """Stage fragment ``f``'s landed result (adopted only on commit).
        LocalSGD: the averaged flat values themselves."""
        with timed_span(self._metrics(), "outer_land",
                        span=f"outer_land_frag{f}"):
            rnd.staged[f] = reduced

    # -- round completion ----------------------------------------------------

    def _finish_round(self, rnd: _SyncRound) -> None:
        mgr = self._manager
        metrics = self._metrics()
        if metrics is not None:
            metrics.gauge("outer_inflight_at_drain", rnd.group.outstanding)
        t0 = time.perf_counter()
        done = rnd.group.seal(lambda: None)
        error: Optional[BaseException] = None
        try:
            done.result()  # the exposed drain
        except Exception as e:  # noqa: BLE001 — latched, the round aborts
            error = e
        rnd.exposed_s += time.perf_counter() - t0
        if error is not None:
            logger.error("sync round fragment failed: %r", error)
            mgr.report_error(error)
        total = sum(
            rnd.wire_t[f] - rnd.submit_t[f]
            for f in range(len(self._fragments))
            if rnd.shipped[f] and rnd.wire_t[f] > 0.0
        )
        if metrics is not None and self._wire_healthy() and total > 0.0:
            exposed = min(rnd.exposed_s, total)
            metrics.gauge("outer_wire_ms", total * 1000.0)
            metrics.gauge("outer_wire_exposed_ms", exposed * 1000.0)
            metrics.gauge(
                "outer_overlap", max(0.0, min(1.0, 1.0 - exposed / total))
            )
            metrics.gauge("outer_wire_bytes", rnd.wire_bytes)
        # Round state is consumed BEFORE the commit barrier: if the barrier
        # raises, the next step() finds local_step >= sync_every with no
        # round active and catches up with a fresh quorum.
        self._round = None
        committed = bool(mgr.should_commit())
        self._local_step = 0
        if committed:
            self._commit_round(rnd)
            return
        logger.warning(
            "sync round aborted; rolling back %d local steps",
            self._sync_every,
        )
        ev = getattr(mgr, "events", None)
        if ev:
            ev.emit(
                "round_abort", source="outer_sync",
                fragments=len(self._fragments),
                inner_steps=self._sync_every,
                wire_world=rnd.world, wire_rank=rnd.rank,
                error=None if error is None else repr(error)[:200],
            )
        self.restore()

    def _commit_round(self, rnd: _SyncRound) -> None:
        """Adopt every fragment's staged average into the backup arena (in
        place) and from there into the live parameters. Sharded: the owned
        fragments' averages ride the commit allgather."""
        if self._sharded_outer and rnd.world > 1:
            self._adopt_gathered(rnd, {
                f: self._frag_native_leaves(f, rnd.staged[f])
                for f in range(len(self._fragments))
                if rnd.staged[f] is not _REMOTE})
            return
        with torch.no_grad():
            for f, (start, stop) in enumerate(self._fragments):
                flat = torch.from_numpy(rnd.staged[f])
                off = 0
                for i in range(start, stop):
                    n = self._sizes[i]
                    view = flat[off:off + n].view(self._shapes[i])
                    if not self._dtypes[i].is_floating_point:
                        # an average of identical integers can sit an ulp
                        # off the integer: round, do not truncate
                        view = torch.round(view)
                    self._backup[i].copy_(view)
                    off += n
        self._push_backup()


class DiLoCo(LocalSGD):
    """Outer/inner-optimizer data parallelism: average pseudogradients per
    fragment and land per-fragment outer steps (module docstring).
    ``outer_tx`` is an ``optim.OuterTransformation`` (``optim.sgd``,
    ``optim.adam``). The round-start fence applies a pending heal before
    the first fragment snapshots, so async-quorum managers work too."""

    def __init__(self, manager, outer_tx: OuterTransformation,
                 sync_every: int,
                 params_fn: Optional[Any] = None,
                 num_fragments: int = 1,
                 streaming: bool = True,
                 error_feedback: "bool | str" = "auto",
                 sharded_outer: bool = False,
                 topology: "Optional[str]" = None) -> None:
        super().__init__(
            manager, sync_every, params_fn=params_fn,
            num_fragments=num_fragments, streaming=streaming,
            error_feedback=error_feedback, sharded_outer=sharded_outer,
            topology=topology,
        )
        from torchft_tpu_torch.comm.redistribute import RedistPlanner

        self._outer = PartitionedOuterOptimizer(outer_tx)
        # the sharded reshard's plans, cached per (holdings, owner map)
        # pair: a kill -> reform oscillation plans nothing new
        self._redist_planner = RedistPlanner()

    def register(self, params: Any) -> Any:
        params = super().register(params)
        # the outer state lives on the host, beside the backup it steps
        self._outer.init([self._backup[start:stop]
                          for start, stop in self._fragments])
        return params

    @property
    def outer_state(self) -> Any:
        """Per-fragment outer states (a list, one per fragment; sharded,
        None for a fragment this rank does not own)."""
        return self._outer.states

    def load_outer_state(self, state: Any) -> None:
        self._outer.load_states(state)

    def state_dict(self) -> dict:
        out = super().state_dict()
        # never mutated in place (every update builds new tensors), so the
        # heal plane may stage them lazily without a copy
        out["outer_state"] = self._outer.states
        return out

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self._outer.load_states(state["outer_state"])

    def _fragment_value_into(self, f: int, out: torch.Tensor) -> None:
        """Outer gradient ``backup - params`` (the paper's sign), computed
        in place in the fragment's f32 arena."""
        self._snapshot_into(f, out)
        start, stop = self._fragments[f]
        off = 0
        for i in range(start, stop):
            n = self._sizes[i]
            seg = out[off:off + n]
            torch.sub(self._backup[i].reshape(-1), seg, out=seg)
            off += n

    def _land_fragment(self, rnd: _SyncRound, f: int,
                       reduced: np.ndarray) -> None:
        """The fragment's outer step from the backup (the last synced
        point, untouched all round), STAGED: parameters and state are
        adopted only on commit. Runs on the bounded worker while later
        fragments still ride the wire; host tensors only."""
        with timed_span(self._metrics(), "outer_land",
                        span=f"outer_land_frag{f}"):
            start, stop = self._fragments[f]
            flat = torch.from_numpy(reduced)
            grads: List[torch.Tensor] = []
            off = 0
            for i in range(start, stop):
                n = self._sizes[i]
                grads.append(flat[off:off + n].view(self._shapes[i]))
                off += n
            rnd.staged[f] = self._outer.update_fragment(
                f, grads, self._backup[start:stop]
            )

    def _adopt_fragment_state(self, f: int,
                              arrays: List[np.ndarray]) -> Dict[str, Any]:
        """A fetched fragment outer state rebuilt from its wire arrays: the
        structure from a fresh ``init_fragment`` over this rank's backup
        leaves (a state is a function of the leaves' shapes), the values
        the donor's bytes, bitwise."""
        start, stop = self._fragments[f]
        template = self._outer.init_fragment(self._backup[start:stop])
        flat, spec = tree_flatten_with_path(template)
        if len(arrays) != len(flat):
            raise ValueError(
                f"fragment {f}: the holder shipped {len(arrays)} outer-state "
                f"arrays, the transformation expects {len(flat)}: outer "
                "optimizer configs diverged across replica groups")
        leaves = []
        for (_, t), a in zip(flat, arrays):
            x = torch.from_numpy(np.array(a, copy=True))
            if x.dtype != t.dtype:
                raise ValueError(
                    f"fragment {f}: outer-state array of {x.dtype}, the "
                    f"transformation holds {t.dtype}")
            leaves.append(x.reshape(t.shape))
        return tree_unflatten(spec, leaves)

    def _on_owner_map(self, rnd: _SyncRound) -> None:
        """The sharded reshard, exchange on heal: when the owner map moved
        (``(world, rank)`` or ``wire_generation()`` changed; a heal counts,
        since a donor ships only its own fragments), the cohort runs one
        redistribution exchange (``comm/redistribute.py`` over the raw-bytes
        heal plane): holdings allgathered, a cached plan, and each ARRIVING
        fragment's outer state fetched from a live holder. Only a fragment
        no live rank holds is reinitialized (``reinit_fragments`` in the
        ``reshard`` event). The trigger is cohort-synchronized, so the
        exchange's collectives stay matched. A failed exchange keeps the
        old states and does not advance the marker: the round aborts at its
        barrier and the next fence retries."""
        gen_fn = getattr(self._manager, "wire_generation", None)
        gen = int(gen_fn()) if callable(gen_fn) else 0
        key = (rnd.world, rnd.rank)
        states = self._outer.states
        if states is None or (key == self._outer_world
                              and gen == self._outer_gen):
            self._outer_world, self._outer_gen = key, gen
            return
        n_frags = len(self._fragments)
        owned = {f for f in range(n_frags) if self._frag_owned(rnd, f)}
        held = [f for f in range(n_frags) if states[f] is not None]
        fetched: Dict[int, List[np.ndarray]] = {}
        wire_bytes = lower_bound = 0
        metrics = self._metrics()
        t0 = time.perf_counter()
        if rnd.world > 1:
            from torchft_tpu_torch.checkpointing import redistribute_exchange
            from torchft_tpu_torch.comm.redistribute import ShardSpec

            holdings = {f: [t for _, t in tree_flatten_with_path(states[f])[0]]
                        for f in held}
            dst = ShardSpec.from_owner_map(
                n_frags, rnd.world, lambda f: self._frag_owner(rnd, f))
            result = redistribute_exchange(
                self._manager, rnd.rank, rnd.world, dst, holdings,
                self._redist_planner, source="outer_sync")
            if result is None:
                return
            fetched = result.fetched
            wire_bytes = result.moved_bytes
            lower_bound = result.lower_bound_bytes
        reinit = dropped = adopted = 0
        new_states: List[Any] = [None] * n_frags
        for f in range(n_frags):
            if f in owned:
                if states[f] is not None:
                    new_states[f] = states[f]
                elif f in fetched:
                    new_states[f] = self._adopt_fragment_state(f, fetched[f])
                    adopted += 1
                else:
                    start, stop = self._fragments[f]
                    new_states[f] = self._outer.init_fragment(
                        self._backup[start:stop])
                    reinit += 1
            elif states[f] is not None:
                dropped += 1
        if reinit:
            logger.warning(
                "sharded_outer reshard reinitialized %d fragment outer "
                "states (no live holder): their outer momentum restarts",
                reinit)
        self._outer.load_states(new_states)
        old = self._outer_world
        self._outer_world, self._outer_gen = key, gen
        if metrics is not None:
            metrics.observe("reshard", time.perf_counter() - t0)
        ev = getattr(self._manager, "events", None)
        if ev:
            ev.emit("reshard", source="outer_sync",
                    old_world=None if old is None else old[0],
                    new_world=rnd.world, rank=rnd.rank,
                    owned_fragments=len(owned), adopted_fragments=adopted,
                    wire_bytes=wire_bytes, lower_bound_bytes=lower_bound,
                    reinit_fragments=reinit, dropped_fragments=dropped)

    def _commit_round(self, rnd: _SyncRound) -> None:
        if self._sharded_outer and rnd.world > 1:
            # the owner adopts each owned fragment's outer state here, at
            # commit, so an aborted round leaves every owned state as it was
            contrib: Dict[int, List[torch.Tensor]] = {}
            for f in range(len(self._fragments)):
                if rnd.staged[f] is _REMOTE:
                    continue
                new_params, new_state = rnd.staged[f]
                self._outer.adopt(f, new_state)
                contrib[f] = new_params
            self._adopt_gathered(rnd, contrib)
            return
        with torch.no_grad():
            for f, (start, stop) in enumerate(self._fragments):
                new_params, new_state = rnd.staged[f]
                self._outer.adopt(f, new_state)
                for i, leaf in zip(range(start, stop), new_params):
                    self._backup[i].copy_(leaf)
        self._push_backup()


def _jax_flatten(tree: Any) -> List[Any]:
    """Leaves of a JAX pytree of plain containers in ``jax.tree_util``'s
    order: dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _jax_flatten(v)]
    return [tree]


def from_jax_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX package ``LocalSGD``/``DiLoCo`` ``state_dict()``, taken as
    numpy (``jax.device_get``), in the port's form: the backup pytree as a
    list of tensors in ``jax.tree_util``'s leaf order (so register the
    port's parameters in that order), the local step, and each fragment's
    optax outer state through ``optim.from_optax_state``."""
    backup = state["backup"]
    out: Dict[str, Any] = {
        "backup": None if backup is None else [
            torch.from_numpy(np.array(x)) for x in _jax_flatten(backup)
        ],
        "local_step": int(state["local_step"]),
    }
    if "outer_state" in state:
        out["outer_state"] = [from_optax_state(s)
                              for s in state["outer_state"]]
    return out
