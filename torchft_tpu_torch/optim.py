"""Commit-gated optimizer wrapper.

Twin of ``OptimizerWrapper`` in ``torchft_tpu/optim.py``, in the reference
torchft shape over a ``torch.optim.Optimizer``: ``begin_step`` (alias
``zero_grad``) starts the quorum and clears the gradients; ``step()`` runs
``optimizer.step()`` only if the replica group commits, and returns whether
it did.

Three paths, as in the reference:

- classic, overlapped (``step``, the default ``donate_update=False``): the
  prologue (``should_commit_async``: drain the collectives, apply a pending
  heal, cast the local vote), then a backup of every parameter and
  optimizer-state tensor and ``optimizer.step()`` enqueued while the
  barrier RPC rides the manager's executor. A commit drops the backup; a
  discard, or a barrier that raises, copies it back in place, ordered
  after the update on the same stream, so every tensor is bitwise what it
  was and keeps its address. So does an exception before the decision (the
  staging, the backup, or an update that wrote part of the state), which
  then reads the decision, drains the fence and re-raises: the vote was
  cast, so the group cannot adopt the step, and the reference's
  functional update leaves no partial write either. The reference's
  non-donated update allocates its outputs beside its inputs; here the
  backup is that transient second footprint (12 bytes a parameter for f32
  AdamW). A False local vote takes no backup and dispatches nothing; a
  decision already final when the prologue returns (an epoch-lease step)
  runs as the decided path.
- classic, decided (``donate_update=True``): the barrier first, then the
  update in place, the reference's donated program; a discarded step
  touches nothing and no second footprint is ever allocated, but the
  barrier RPC is exposed.
- fused (``can_fuse`` -> ``fused_step``): on a solo wire the average is an
  identity, so the barrier runs first and then one fused forward +
  backward + update, a CUDA graph on the card (``models.make_train_step``).

A heal applies the donor's state through the user's ``load_state_dict``
inside the barrier, into the very tensors this optimizer holds, so the
committed update lands on the healed state. ``fused_step`` then has the
fused function re-read the state (``sync_state``), so a load that replaced
tensors makes the graph re-capture. The overlapped path takes its backup
after the prologue, so a discard restores the healed state; and since its
update lands before the barrier closes the serving gate, it first waits
until the state this replica serves to a healer has been copied off the
live tensors (``Manager.finish_staging``).

The fence bounds how far the host runs ahead of the card: each committed
step pushes an entry (a CUDA event, and the step's loss), and the entry from
``fence_depth`` steps ago is waited out. Fused-path entries are read back
``fence_stride`` at a time in one ``torch.stack(...).cpu()``; a classic
entry waits its event at once. Every non-committing step drains the fence.
The losses read back land in ``take_losses()``, keyed by the step count
after the commit. ``metrics`` times ``prologue``, ``barrier``,
``dispatch``, ``fence`` and ``transition_drain`` over every step, the
reference's names; ``fused_metrics`` and ``classic_metrics`` the same
phases of fused steps alone and of classic steps alone.

``step`` also takes the future ``DistributedDataParallel.average_gradients_async``
returned and resolves it before the prologue: a loop may submit the average
and hand the unresolved future straight to ``step``. A failed future latches
its error, so the step discards.

DiLoCo's outer optimizer (local_sgd.py) must stage a step and adopt it only
if the round commits, which ``torch.optim.Optimizer`` (it updates in place)
cannot. So it runs on :class:`OuterTransformation`, a functional
transformation in optax's shape and order of operations (``sgd`` with
optional momentum and Nesterov, ``adam``, ``adamw``), partitioned per
fragment by :class:`PartitionedOuterOptimizer`.

:class:`ShardedOptimizerWrapper` is the cross-replica sharded weight update
(ZeRO style): reduce-scatter of the gradients, an update of this rank's 1/N
leaf shard against per-leaf states (:class:`ShardedOptState`), the commit
barrier, then an allgather of the updated parameters into the
``nn.Parameter`` s in place. Its per-leaf update is an
:class:`OuterTransformation` too (the reference example's ``adamw``), never
``torch.optim.AdamW``, whose decoupled decay runs in another order.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import Future
from contextlib import contextmanager, nullcontext
from typing import (Any, Callable, ContextManager, Dict, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from torchft_tpu_torch.utils.metrics import Metrics

logger = logging.getLogger(__name__)

__all__ = ["OptimizerWrapper", "OuterTransformation",
           "PartitionedOuterOptimizer", "ShardedOptState",
           "ShardedOptimizerWrapper", "TransformationOptimizer", "adam",
           "adamw", "apply_updates",
           "from_optax_state", "init_adam_state", "load_optimizer_state_dict",
           "sgd"]


def _hyper(group: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in group.items() if k != "params"}


def _loads_in_place(optimizer: torch.optim.Optimizer,
                    state_dict: Dict[str, Any]) -> bool:
    groups, saved = optimizer.param_groups, state_dict["param_groups"]
    if len(groups) != len(saved):
        return False
    try:
        if any(_hyper(g) != _hyper(s) for g, s in zip(groups, saved)):
            return False
    except RuntimeError:  # a tensor hyperparameter: compare no further
        return False
    params = [p for g in groups for p in g["params"]]
    ids = [i for g in saved for i in g["params"]]
    if len(params) != len(ids):
        return False
    for p, i in zip(params, ids):
        cur, new = optimizer.state.get(p), state_dict["state"].get(i)
        if not cur or not new or cur.keys() != new.keys():
            return False
        for k, v in cur.items():
            if isinstance(v, torch.Tensor) != isinstance(new[k], torch.Tensor):
                return False
            if isinstance(v, torch.Tensor) and v.shape != new[k].shape:
                return False
    return True


def init_adam_state(optimizer: torch.optim.Optimizer) -> None:
    """Create an Adam or AdamW optimizer's per-parameter state now, as its
    first ``step()`` would (step 0, zero moments), instead of lazily: an
    optimizer that never stepped then lists the same state leaves as one
    that did, so its ``state_dict()`` is a heal template (optax creates its
    state at ``init`` too). The first step is bitwise the lazy one's."""
    with torch.no_grad():
        for group in optimizer.param_groups:
            on_device = group.get("capturable") or group.get("fused")
            scalar = torch.float64 \
                if torch.get_default_dtype() == torch.float64 \
                else torch.float32
            for p in group["params"]:
                state = optimizer.state[p]
                if state:
                    continue
                state["step"] = (
                    torch.zeros((), dtype=scalar, device=p.device)
                    if on_device else torch.tensor(0.0, dtype=scalar))
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                if group.get("amsgrad"):
                    state["max_exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)


def init_sgd_state(optimizer: torch.optim.SGD) -> None:
    """Create an SGD optimizer's momentum buffers now (zeros) instead of at
    its first step, so a fresh optimizer's state lists the leaves a
    stepped one's does (a heal template before any step). The first step
    is the lazy one's: ``0 * momentum + grad``."""
    with torch.no_grad():
        for group in optimizer.param_groups:
            if not group.get("momentum"):
                continue
            for p in group["params"]:
                state = optimizer.state[p]
                if state.get("momentum_buffer") is None:
                    state["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)


def load_optimizer_state_dict(optimizer: torch.optim.Optimizer,
                              state_dict: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict(state_dict)``, but copied into the
    existing state tensors where every parameter already has state of the
    same keys and shapes under the same hyperparameters: a CUDA graph
    captured over those tensors stays valid. Otherwise a plain load, which
    builds new tensors."""
    if not _loads_in_place(optimizer, state_dict):
        optimizer.load_state_dict(state_dict)
        return
    params = [p for g in optimizer.param_groups for p in g["params"]]
    ids = [i for g in state_dict["param_groups"] for i in g["params"]]
    with torch.no_grad():
        for p, i in zip(params, ids):
            state = optimizer.state[p]
            for k, v in state_dict["state"][i].items():
                if isinstance(state[k], torch.Tensor):
                    state[k].copy_(v)
                else:
                    state[k] = v


def _copy_batched(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """``d.copy_(s)`` for each pair, one ``_foreach_copy_`` per device and
    dtype (a few launches on the card, not one a tensor)."""
    groups: Dict[Tuple[torch.device, torch.dtype], Tuple[list, list]] = {}
    for d, s in zip(dst, src):
        ds, ss = groups.setdefault((d.device, d.dtype), ([], []))
        ds.append(d)
        ss.append(s)
    with torch.no_grad():
        for ds, ss in groups.values():
            torch._foreach_copy_(ds, ss)


class OptimizerWrapper:
    """Gates ``optimizer.step()`` on the manager's two-phase commit."""

    def __init__(self, manager, optimizer: torch.optim.Optimizer,
                 fence_depth: int = 1, fence_stride: int = 8,
                 donate_update: bool = False,
                 update_window: Optional[
                     Callable[[], ContextManager[Any]]] = None) -> None:
        """``donate_update``: False (the reference's default) overlaps the
        update with the barrier RPC behind a backup; True decides first
        and updates in place (module docstring). ``update_window()``: a
        context manager entered around each classic step's update, after
        the prologue (overlapped: the backup, the update, the decision and
        the restore or the drop; decided: the update), for a caller that
        reads the device memory the update takes."""
        self.manager = manager
        self.optimizer = optimizer
        self._donate_update = bool(donate_update)
        self._update_window = update_window or nullcontext
        # entries (kind, event, loss, step): "block" for a classic step,
        # "readback" for a fused one
        self._fence_depth = fence_depth
        self._fence_stride = max(1, fence_stride)
        self._in_flight: List[Tuple[str, Any, Any, int]] = []
        self._losses: Dict[int, float] = {}
        self._cuda = any(p.is_cuda for g in optimizer.param_groups
                         for p in g["params"])
        self.fused_steps = 0
        self.classic_steps = 0
        self.metrics = Metrics(window=512)
        self.fused_metrics = Metrics(window=512)
        self.classic_metrics = Metrics(window=512)

    @contextmanager
    def _fused_timed(self, name: str) -> Iterator[None]:
        """Time a fused step's phase into both sinks."""
        with self.metrics.timed(name), self.fused_metrics.timed(name):
            yield

    @contextmanager
    def _classic_timed(self, name: str) -> Iterator[None]:
        """Time a classic step's phase into both sinks."""
        with self.metrics.timed(name), self.classic_metrics.timed(name):
            yield

    def begin_step(self, **kwargs) -> None:
        """Start the (async) quorum and clear the gradients — call before
        the forward pass."""
        self.manager.start_quorum(**kwargs)
        self.optimizer.zero_grad(set_to_none=False)

    zero_grad = begin_step

    # ----------------------------------------------------------- classic

    def step(self, loss: Optional[torch.Tensor] = None,
             grads: Optional[Future] = None) -> bool:
        """Apply the update iff the replica group commits this step.
        ``loss`` (optional) is read back through the fence. ``grads``: the
        future of ``average_gradients_async``, resolved here before the
        prologue (the average lands in ``.grad`` in place); its failure is
        latched, so the step discards."""
        self.classic_steps += 1
        if isinstance(loss, Future):
            loss, grads = None, loss
        if grads is not None:
            try:
                grads.result()
            except Exception as e:  # noqa: BLE001 — the barrier discards
                self.manager.report_error(e)
        with self._classic_timed("prologue"):
            decision = self.manager.should_commit_async()
        if self._donate_update or decision.done():
            return self._step_decided(decision, loss)
        backup = None
        with self._update_window():
            if getattr(decision, "local_should_commit", True):
                try:
                    with self._classic_timed("dispatch"):
                        # healers read host copies of the served state:
                        # finish them before the update lands on the live
                        # tensors
                        self.manager.finish_staging()
                        backup = self._backup()
                        self.optimizer.step()
                except BaseException as e:
                    self._abandon(decision, backup, e)
            # the exposed barrier: what the RPC costs beyond the dispatch
            try:
                with self._classic_timed("barrier"):
                    committed = bool(decision.result())
            except BaseException:
                self._roll_back(backup)
                self._drain_fence()
                raise
            if not (committed and backup is not None):
                self._drain_fence()
                self._roll_back(backup)
                return False
            backup = None  # the allocator frees the second footprint
        with self._classic_timed("fence"):
            self._push_fence("block", loss)
        return True

    def _abandon(self, decision: Future, backup, exc: BaseException) -> None:
        """The overlapped step raised before its decision (the staging, the
        backup, or an update that may have written part of the state):
        restore the backup in place, read the decision, drain the fence and
        re-raise ``exc``, with a failing barrier chained to it. The vote
        was already cast, so this group cannot adopt the step: it crashes,
        restarts and heals, as the reference's does."""
        self._roll_back(backup)
        try:
            with self._classic_timed("barrier"):
                decision.result()
        except Exception:
            raise exc  # the barrier's failure becomes its __context__
        finally:
            self._drain_fence()
        raise exc

    def _step_decided(self, decision: Future,
                      loss: Optional[torch.Tensor]) -> bool:
        """Decide, then apply in place: the donated arm, and any step whose
        decision was final when the prologue returned."""
        try:
            with self._classic_timed("barrier"):
                committed = bool(decision.result())
        except BaseException:
            self._drain_fence()
            raise
        if committed:
            with self._update_window(), self._classic_timed("dispatch"):
                self.optimizer.step()
            with self._classic_timed("fence"):
                self._push_fence("block", loss)
            return True
        self._drain_fence()
        return False

    def _backup(self) -> Tuple[list, List[torch.Tensor],
                               List[torch.Tensor]]:
        """A copy of every parameter and optimizer-state tensor, on its
        tensor's device and current stream, one batched copy per device
        and dtype; and each parameter's state entries as they are now
        (None where the step creates the state lazily)."""
        states, live = [], []
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                state = self.optimizer.state.get(p)
                live.append(p.detach())
                states.append((p, None if state is None else dict(state)))
                if state is not None:
                    live += [v for v in state.values()
                             if isinstance(v, torch.Tensor)]
        copies = [torch.empty_like(t) for t in live]
        _copy_batched(copies, live)
        return states, live, copies

    def _roll_back(self, backup) -> None:
        """Copy ``backup`` back into the same tensors (their addresses,
        which a captured CUDA graph and DDP's views hold, do not move), put
        back each state's entries, free the copies, and wait out the update
        that was not adopted with its restore: a run of discards must not
        leave programs queued without bound."""
        if backup is None:
            return
        states, live, copies = backup
        _copy_batched(live, copies)
        for p, saved in states:
            if saved is None:
                self.optimizer.state.pop(p, None)
            else:
                state = self.optimizer.state[p]
                state.clear()
                state.update(saved)
        copies.clear()  # free them now, not with a raised frame
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        self._wait_batch([("block", event, None,
                           self.manager.current_step())])

    # ------------------------------------------------------------- fused

    def can_fuse(self) -> bool:
        """True when this step's wire is solo, so the cross-replica average
        is an identity and the step may run as one fused program through
        :meth:`fused_step`. Waits the quorum itself; a quorum failure is
        latched (the commit gate discards the step) and returns False."""
        try:
            self.manager.wait_quorum()
        except Exception as e:  # noqa: BLE001 — every failure means "no"
            self.manager.report_error(e)
            return False
        return self.manager.is_solo_wire()

    def fused_step(self, fused_fn: Callable[..., torch.Tensor],
                   *args) -> Tuple[Optional[torch.Tensor], bool]:
        """Solo-wire path: the commit barrier first, then ``fused_fn(*args)``
        (forward, backward and update, returning the loss). Returns
        ``(loss, committed)``; the loss is None on a discarded step, which
        runs nothing. Sound because the local vote never depends on the
        gradient's values and a solo wire has no collective to fail
        between the vote and the update. Call only when :meth:`can_fuse`
        returned True this step."""
        self.fused_steps += 1
        with self._fused_timed("barrier"):
            committed = self.manager.should_commit()
        if not committed:
            self._drain_fence()
            return None, False
        if self.manager.did_heal():
            # the barrier loaded the donor's state: a fused function that
            # captured the old tensors must see the new ones
            sync = getattr(fused_fn, "sync_state", None)
            if callable(sync):
                sync()
        if any(kind == "block" for kind, *_ in self._in_flight):
            # classic -> fused transition: wait the classic updates out
            # before the graph replays over the same tensors
            with self._fused_timed("transition_drain"):
                self._drain_fence()
        with self._fused_timed("dispatch"):
            loss = fused_fn(*args)
        with self._fused_timed("fence"):
            self._push_fence("readback", loss)
        return loss, True

    # ------------------------------------------------------------- fence

    def _push_fence(self, kind: str, loss: Optional[torch.Tensor]) -> None:
        """Enqueue this committed step's entry and wait out the one from
        ``fence_depth`` steps ago ("block": at once, down to the depth;
        "readback": ``fence_stride`` entries in one batch)."""
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        entry = (kind, event, loss, self.manager.current_step())
        if self._fence_depth <= 0:
            self._wait_batch([entry])
            return
        self._in_flight.append(entry)
        excess = len(self._in_flight) - self._fence_depth
        if kind == "block":
            # drain to depth, not one per push: a fused -> classic
            # transition inherits up to depth + stride - 1 entries
            if excess > 0:
                self._wait_batch(self._pop(excess))
        elif excess >= self._fence_stride:
            self._wait_batch(self._pop(excess))

    def _pop(self, n: int) -> list:
        out, self._in_flight = self._in_flight[:n], self._in_flight[n:]
        return out

    def _drain_fence(self) -> None:
        entries, self._in_flight = self._in_flight, []
        self._wait_batch(entries)

    def drain(self) -> Dict[int, float]:
        """Wait out every fence entry and return the losses read back so
        far (``take_losses``)."""
        self._drain_fence()
        return self.take_losses()

    def _wait_batch(self, entries) -> None:
        if not entries:
            return
        for kind, event, _, _ in entries:
            if kind == "block" and event is not None:
                event.synchronize()
        with_loss = [(step, loss) for _, _, loss, step in entries
                     if loss is not None]
        if with_loss:
            # one device-to-host copy for every loss of the batch
            values = torch.stack(
                [loss.detach().float().reshape(()) for _, loss in with_loss]
            ).cpu().tolist()
            for (step, _), v in zip(with_loss, values):
                self._losses[step] = v

    def take_losses(self) -> Dict[int, float]:
        """The losses read back since the last call, keyed by the step
        count after their commit."""
        out, self._losses = self._losses, {}
        return out

    # ------------------------------------------------------------- state

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict) -> None:
        load_optimizer_state_dict(self.optimizer, state_dict)


# ------------------------------------------------------- outer optimizer


class OuterTransformation:
    """A pure gradient transformation over a list of tensors, in optax's
    order of operations: ``init(leaves) -> state`` and ``update(grads,
    state, params) -> (updates, new_state)``, never mutating its inputs.
    The state is a dict of tensors: ``{}`` for plain SGD, ``{"trace":
    [...]}`` with momentum, ``{"count", "mu", "nu"}`` for Adam. Build one
    with :func:`sgd` or :func:`adam`."""

    def __init__(self, kind: str, learning_rate: float, *,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0) -> None:
        self.kind = kind
        self.learning_rate = float(learning_rate)
        self.momentum = momentum
        self.nesterov = nesterov
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = float(weight_decay)

    def init(self, leaves: Sequence[torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: [torch.zeros_like(x) for x in leaves]  # noqa: E731
        if self.kind in ("adam", "adamw"):
            return {"count": torch.zeros((), dtype=torch.int32),
                    "mu": zeros(), "nu": zeros()}
        if self.momentum is not None:
            return {"trace": zeros()}
        return {}

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        new_state: Dict[str, Any] = {}
        if self.kind in ("adam", "adamw"):
            b1, b2 = self.b1, self.b2
            # (1 - decay) * g**order + decay * t, then the bias correction
            # 1 - decay**count in f32, as optax computes them
            mu = [g * (1 - b1) + t * b1 for g, t in zip(grads, state["mu"])]
            nu = [(g * g) * (1 - b2) + t * b2
                  for g, t in zip(grads, state["nu"])]
            count = state["count"] + 1
            c = count.to(torch.float32)
            # the bases are filled on the device, so a CUDA graph can
            # capture the update (a host tensor would be a copy)
            bc1 = 1 - torch.full((), b1, dtype=torch.float32,
                                 device=c.device) ** c
            bc2 = 1 - torch.full((), b2, dtype=torch.float32,
                                 device=c.device) ** c
            updates = [(m / bc1.to(m.dtype))
                       / (torch.sqrt(v / bc2.to(v.dtype)) + self.eps)
                       for m, v in zip(mu, nu)]
            if self.kind == "adamw":
                # optax's add_decayed_weights, after the Adam scaling
                if params is None:
                    raise ValueError("adamw's update reads the parameters")
                updates = [u + self.weight_decay * p
                           for u, p in zip(updates, params)]
            new_state = {"count": count, "mu": mu, "nu": nu}
        elif self.momentum is not None:
            decay = self.momentum
            trace = [g + t * decay for g, t in zip(grads, state["trace"])]
            updates = ([g + t * decay for g, t in zip(grads, trace)]
                       if self.nesterov else trace)
            new_state = {"trace": trace}
        else:
            updates = list(grads)
        return [u * -self.learning_rate for u in updates], new_state


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> OuterTransformation:
    """``optax.sgd``: a momentum trace (``g + decay * trace``, Nesterov
    ``g + decay * new_trace``) when ``momentum`` is set, then scale by
    ``-learning_rate``."""
    return OuterTransformation("sgd", learning_rate, momentum=momentum,
                               nesterov=nesterov)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OuterTransformation:
    """``optax.adam`` (``eps_root`` 0)."""
    return OuterTransformation("adam", learning_rate, b1=b1, b2=b2, eps=eps)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> OuterTransformation:
    """``optax.adamw`` (``eps_root`` 0, no mask): Adam's scaling, then
    ``+ weight_decay * params``, then ``-learning_rate``."""
    return OuterTransformation("adamw", learning_rate, b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay)


class TransformationOptimizer(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` stepping its parameters in place by an
    Adam :class:`OuterTransformation` (``adamw(3e-4)``: optax's order, the
    weight decay added to the Adam update rather than applied to the
    parameters first as ``torch.optim.AdamW`` does). ``step`` runs the
    transformation's arithmetic parameter by parameter, op for op as
    ``tx.update`` then ``optax.apply_updates`` (so bitwise theirs), with
    the moments and the parameter updated in place: the transients are one
    parameter's, never a second copy of the state. The state is per
    parameter (``mu``, ``nu`` and ``count`` on the parameter's device) and
    exists from construction, as optax's ``init``, so ``state_dict()`` is
    a heal template from the first step and ``load_optimizer_state_dict``
    loads into it in place."""

    def __init__(self, params, tx: OuterTransformation) -> None:
        if tx.kind not in ("adam", "adamw"):
            raise ValueError(f"TransformationOptimizer steps adam or adamw, "
                             f"not {tx.kind}")
        super().__init__(params, {})
        self.tx = tx
        for p in self._params():
            self.state[p].update(
                count=torch.zeros((), dtype=torch.int32, device=p.device),
                mu=torch.zeros_like(p), nu=torch.zeros_like(p))

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("TransformationOptimizer takes no closure")
        params = [p for p in self._params() if p.grad is not None]
        if not params:
            return None
        tx = self.tx
        count = self.state[params[0]]["count"] + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.full((), tx.b1, dtype=torch.float32,
                             device=c.device) ** c
        bc2 = 1 - torch.full((), tx.b2, dtype=torch.float32,
                             device=c.device) ** c
        for p in params:
            # OuterTransformation.update's expressions, in place
            g, state = p.grad, self.state[p]
            mu, nu = state["mu"], state["nu"]
            mu.mul_(tx.b1).add_(g * (1 - tx.b1))
            nu.mul_(tx.b2).add_(torch.mul(g, g).mul_(1 - tx.b2))
            # the corrections on this parameter's card (a mesh over cards
            # holds its pieces on several)
            u = torch.div(mu, bc1.to(mu)).div_(
                torch.div(nu, bc2.to(nu)).sqrt_().add_(tx.eps))
            if tx.kind == "adamw":
                u.add_(tx.weight_decay * p)
            p.add_(u.mul_(-tx.learning_rate))
            state["count"].copy_(count)
        return None


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``optax.apply_updates``: ``p + u`` in the parameter's dtype."""
    return [(p + u).to(p.dtype) for p, u in zip(params, updates)]


def from_optax_state(state: Any) -> Dict[str, Any]:
    """One fragment's optax state (a chain tuple of ``TraceState`` /
    ``ScaleByAdamState`` / empty states, as numpy arrays) in the port's
    form, by field name: ``trace``, ``mu`` and ``nu`` lists of tensors and
    ``count`` a 0-dim int32 tensor."""
    out: Dict[str, Any] = {}

    def walk(node: Any) -> None:
        fields = getattr(node, "_fields", None)
        if fields is not None:
            for name in fields:
                value = getattr(node, name)
                if name == "count":
                    out["count"] = torch.tensor(np.asarray(value),
                                                dtype=torch.int32)
                elif name in ("trace", "mu", "nu"):
                    out[name] = [torch.from_numpy(np.array(v))
                                 for v in value]
                else:
                    walk(value)
        elif isinstance(node, (tuple, list)):
            for member in node:
                walk(member)

    walk(state)
    return out


class PartitionedOuterOptimizer:
    """One outer transformation partitioned per fragment (twin of the
    reference's, optim.py:38-106): each fragment owns its own state over
    its own leaf list, so a fragment's outer step lands the moment its
    average comes off the wire. For the elementwise transformations here
    the concatenation of per-fragment updates is the monolithic update.

    :meth:`update_fragment` is pure: it returns the staged ``(new_params,
    new_state)``, and the round adopts the state with :meth:`adopt` only
    after the commit vote, so an aborted round leaves every fragment's
    state untouched. ``adopt`` replaces the state list rather than
    mutating it, so a snapshot taken before (``states``) never changes
    under its holder."""

    def __init__(self, tx: OuterTransformation) -> None:
        self._tx = tx
        self._states: Optional[List[Any]] = None

    def init(self, fragments: Sequence[Sequence[torch.Tensor]]) -> None:
        """One state per fragment, over that fragment's leaf list."""
        self._states = [self._tx.init(list(f)) for f in fragments]

    def init_fragment(self, leaves: Sequence[torch.Tensor]) -> Any:
        """A fresh state for one fragment's leaf list."""
        return self._tx.init(list(leaves))

    @property
    def states(self) -> Optional[List[Any]]:
        return self._states

    def load_states(self, states: Sequence[Any]) -> None:
        self._states = list(states)

    def update_fragment(self, f: int, grads: Sequence[torch.Tensor],
                        params: Sequence[torch.Tensor]
                        ) -> Tuple[List[torch.Tensor], Any]:
        """The staged outer step of fragment ``f``: ``(new_params,
        new_state)``, the state not adopted."""
        assert self._states is not None, "init() was never called"
        updates, new_state = self._tx.update(list(grads), self._states[f],
                                             list(params))
        return apply_updates(list(params), updates), new_state

    def adopt(self, f: int, new_state: Any) -> None:
        assert self._states is not None, "init() was never called"
        states = list(self._states)
        states[f] = new_state
        self._states = states


# ------------------------------------------------- sharded weight update


class ShardedOptState:
    """The sharded optimizer state: one transformation state per parameter
    leaf, held only for the leaves this rank's shard owns. ``ranges``,
    ``rank`` and ``world_size`` record the grid the held states were built
    for; ``wire_gen`` the transport incarnation the grid was adopted
    under, the reshard trigger."""

    __slots__ = ("world_size", "rank", "ranges", "leaf_states", "wire_gen")

    def __init__(self, n_leaves: int, world_size: int = 0, rank: int = 0,
                 ranges: Sequence[Tuple[int, int]] = (),
                 leaf_states: Optional[List[Any]] = None,
                 wire_gen: Optional[int] = None) -> None:
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.ranges = tuple(tuple(r) for r in ranges)
        self.leaf_states: List[Any] = (list(leaf_states)
                                       if leaf_states is not None
                                       else [None] * int(n_leaves))
        self.wire_gen = wire_gen

    def held(self) -> List[int]:
        return [i for i, s in enumerate(self.leaf_states) if s is not None]

    def state_bytes(self) -> int:
        return sum(int(t.nbytes) for s in self.leaf_states if s is not None
                   for t in _state_tensors(s))


def state_leaf_names(state: Dict[str, Any]) -> Tuple[str, ...]:
    """The slots of one leaf's :class:`OuterTransformation` state in the
    JAX package's (optax's) order: ``count, mu, nu`` for Adam(W),
    ``trace`` with momentum, none for plain SGD."""
    if "count" in state:
        return ("count", "mu", "nu")
    if "trace" in state:
        return ("trace",)
    return ()


def _state_tensors(state: Dict[str, Any]) -> List[torch.Tensor]:
    """One leaf's state flattened in the JAX package's slot order
    (:func:`state_leaf_names`)."""
    return [state[n] if n == "count" else state[n][0]
            for n in state_leaf_names(state)]


def state_from_leaves(names: Sequence[str],
                      leaves: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`_state_tensors`."""
    return {n: (t if n == "count" else [t]) for n, t in zip(names, leaves)}


class ShardedOptimizerWrapper:
    """The cross-replica sharded weight update (twin of the reference's
    ``ShardedOptimizerWrapper``, torchft_tpu/optim.py), over the
    ``nn.Parameter`` s ``params``, updated in place:

        reduce-scatter(grads) -> 1/N update -> barrier -> allgather(params)

    Each wire rank receives its byte-balanced leaf shard of the averaged
    gradient (``ddp.ShardedGradReducer``), updates only those leaves with
    ``tx`` (an elementwise :class:`OuterTransformation`, e.g.
    :func:`adamw`) against per-leaf states, and a committed step
    allgathers the updated shards into every parameter. Optimizer state,
    update work and heal bytes divide by the wire world size.

    ``sharded=False`` is the A/B lever and bitwise oracle: the same buckets
    ride an allreduce and every rank updates every leaf with the same
    per-leaf function. ``sharded``, ``redistribute`` and ``model_shards``
    must match across replicas (they change the collective sequence).

    Resharding: every transport incarnation change runs one exchange
    (comm/redistribute.py over the heal plane): a holdings-metadata
    allgather, a cached transfer plan, and point-to-point fetches of
    exactly the leaf states whose owner changed
    (``redist_moved_bytes == redist_lower_bound_bytes``).
    ``redistribute="allgather"`` allgathers every departing state to the
    whole cohort instead (the A/B arm). States no survivor holds are
    reinitialized, counted in the ``reshard`` event's ``reinit_leaves``.

    ``step`` reads the parameters' ``.grad`` (raw per-replica gradients:
    the wrapper owns the reduction), or a list of gradient tensors, or a
    future resolving to one. A heal applies the donor's parameters in
    place and its shard through :meth:`load_opt_state_dict` inside the
    commit prologue, before the update reads them. The params allgather
    runs after the barrier: if it fails on a committed step, ``step``
    raises, and the replica restarts and heals."""

    def __init__(self, manager, tx: OuterTransformation, params,
                 sharded: bool = True,
                 error_feedback: "bool | str" = "auto",
                 redistribute: str = "plan",
                 planner=None,
                 model_shards: "int | str" = "auto") -> None:
        from torchft_tpu_torch.comm.redistribute import RedistPlanner
        from torchft_tpu_torch.ddp import ShardedGradReducer

        if redistribute not in ("plan", "allgather"):
            raise ValueError(
                f"redistribute must be 'plan' (minimal transfer plans over "
                f"the heal plane) or 'allgather' (the full-departing-leaf "
                f"broadcast A/B arm), got {redistribute!r}; the choice "
                "must match across replicas")
        self.manager = manager
        self.tx = tx
        self.params: List[torch.Tensor] = (
            list(params.parameters()) if isinstance(params, torch.nn.Module)
            else list(params))
        self._sharded = bool(sharded)
        self._redistribute = redistribute
        if model_shards == "auto":
            model_shards = getattr(manager, "model_shards", 1)
        self._model_shards = max(1, int(model_shards))
        self._planner = planner if planner is not None else RedistPlanner()
        self._reducer = ShardedGradReducer(manager,
                                           error_feedback=error_feedback)
        self._state_slots = len(_state_tensors(
            tx.init([torch.zeros(1)])))
        # held-state bytes change only at grid changes
        self._state_bytes: Optional[float] = None
        self.state = ShardedOptState(len(self.params))

    @property
    def sharded(self) -> bool:
        return self._sharded

    @property
    def state_slots(self) -> int:
        """Arrays per leaf state (``fetch_opt_shard``'s ``state_slots``)."""
        return self._state_slots

    def bucket_sizes(self) -> List[int]:
        """Element counts of the gradient buckets at the last wire world
        (empty before the first step): one reduce_scatter per step."""
        plan = self._reducer.last_plan()
        if plan is None:
            return []
        return [sum(plan.sizes[i] for i in b) for b in plan.buckets]

    def init(self) -> ShardedOptState:
        """A fresh unsharded state: the per-leaf states materialize at the
        first step, once the wire world is known (the supported
        transformations init to zeros, so deferring is bitwise)."""
        self.state = ShardedOptState(len(self.params))
        self._state_bytes = None
        return self.state

    def begin_step(self, **kwargs) -> None:
        """Start the (async) quorum and clear the gradients."""
        self.manager.start_quorum(**kwargs)
        for p in self.params:
            if p.grad is not None:
                p.grad.zero_()

    zero_grad = begin_step

    def _metrics(self):
        return getattr(self.manager, "metrics", None)

    def _leaf_init(self, i: int) -> Dict[str, Any]:
        return self.tx.init([self.params[i].detach()])

    def _unflatten_state(self, arrays: Sequence[Any],
                         i: int) -> Dict[str, Any]:
        """Slot arrays (host arrays or tensors) as leaf ``i``'s state, the
        count on the host and the moments on the parameter's device."""
        if len(arrays) != self._state_slots:
            raise ValueError(
                f"leaf state has {len(arrays)} arrays, the transformation "
                f"expects {self._state_slots}: optimizer configs diverged "
                "across replicas")
        device = self.params[i].device

        def t(a: Any, dev) -> torch.Tensor:
            x = a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.array(a, copy=True))
            return x.to(dev).clone()

        if self._state_slots == 3:
            return {"count": t(arrays[0], "cpu").to(torch.int32),
                    "mu": [t(arrays[1], device)],
                    "nu": [t(arrays[2], device)]}
        if self._state_slots == 1:
            return {"trace": [t(arrays[0], device)]}
        return {}

    def _host_slots(self, state: Dict[str, Any]) -> List[np.ndarray]:
        return [t.detach().cpu().numpy() for t in _state_tensors(state)]

    # ------------------------------------------------------------ reshard

    def _maybe_reshard(self, state: ShardedOptState, plan,
                       my_rank: int) -> ShardedOptState:
        """Redistribute the per-leaf states at the quorum boundary when the
        transport incarnation changed (a membership change, a heal, the
        first step). Every wire member runs it at the same step, so its
        collectives stay matched."""
        from torchft_tpu_torch.checkpointing import (
            join_leaf_payload,
            redistribute_exchange,
            split_leaf_payload,
        )

        mgr = self.manager
        gen_fn = getattr(mgr, "wire_generation", None)
        gen = int(gen_fn()) if callable(gen_fn) else 0
        world = plan.world_size
        ranges = tuple(tuple(r) for r in plan.ranges)
        n_leaves = len(state.leaf_states)
        if not self._sharded:
            # replicated arm: every rank owns every leaf, no exchange
            missing = [i for i, s in enumerate(state.leaf_states) if s is None]
            for i in missing:
                state.leaf_states[i] = self._leaf_init(i)
            state.world_size, state.rank = 1, 0
            state.ranges = ((0, n_leaves),)
            state.wire_gen = gen
            if missing or self._state_bytes is None:
                self._state_bytes = float(state.state_bytes())
            return state
        if (state.wire_gen == gen and state.ranges == ranges
                and state.rank == my_rank):
            return state
        owned = set(plan.owned_leaves(my_rank))
        held = set(state.held())
        # available: leaf states that arrived off the wire; wire_bytes:
        # what the exchange received; lower_bound: the bytes of
        # owned-but-missing states some survivor holds
        available: Dict[int, List[Any]] = {}
        wire_bytes = lower_bound = 0
        if world > 1 and self._redistribute == "plan":
            m = self._model_shards
            if m > 1:
                holdings = {
                    i * m + k: pieces for i in sorted(held)
                    for k, pieces in enumerate(split_leaf_payload(
                        self._host_slots(state.leaf_states[i]), m))}
            else:
                # device tensors: a unit stages when a receiver fetches it
                holdings = {i: _state_tensors(state.leaf_states[i])
                            for i in sorted(held)}
            result = redistribute_exchange(mgr, my_rank, world,
                                           plan.shard_spec(m), holdings,
                                           self._planner, source="reshard")
            if result is None:
                # latched wire or a transfer failed whole: keep the old
                # grid; the step discards and the next quorum retries
                return state
            wire_bytes = result.moved_bytes
            lower_bound = result.lower_bound_bytes
            if m > 1:
                for i in sorted(owned - held):
                    subs = [result.fetched.get(i * m + k) for k in range(m)]
                    if any(sub is None for sub in subs):
                        continue
                    shapes = [tuple(a.shape) for a in
                              _state_tensors(self._leaf_init(i))]
                    try:
                        available[i] = join_leaf_payload(subs, shapes)
                    except ValueError:
                        logger.warning("reshard: leaf %d sub-units did not "
                                       "reassemble; reinitializing", i)
            else:
                available = result.fetched
        elif world > 1:
            # the allgather A/B arm: [outgoing indices] + each outgoing
            # leaf's slot arrays, in index order
            outgoing = sorted(held - owned)
            contrib: List[np.ndarray] = [np.asarray(outgoing, np.int64)]
            for i in outgoing:
                contrib.extend(self._host_slots(state.leaf_states[i]))
            gathered = mgr.allgather_arrays(contrib).future().result()
            errored = getattr(mgr, "errored", None)
            if callable(errored) and errored() is not None:
                return state
            k = self._state_slots
            for r, rank_arrays in enumerate(gathered):
                if not rank_arrays:
                    continue
                idx = np.asarray(rank_arrays[0]).astype(np.int64).reshape(-1)
                pos = 1
                for i in idx.tolist():
                    slot = [np.asarray(a) for a in rank_arrays[pos: pos + k]]
                    pos += k
                    if r != my_rank:
                        wire_bytes += sum(int(a.nbytes) for a in slot)
                    available.setdefault(int(i), slot)
            lower_bound = sum(sum(int(a.nbytes) for a in available[i])
                              for i in owned - held if i in available)
            metrics = self._metrics()
            if metrics is not None:
                metrics.incr("redist_moved_bytes", float(wire_bytes))
                metrics.incr("redist_lower_bound_bytes", float(lower_bound))
        new_states: List[Any] = [None] * n_leaves
        moved_bytes = kept = 0
        reinit: List[int] = []
        # a fresh wrapper's first grid materializes every owned state
        # (deferred zero-init, not a loss)
        had_grid = state.world_size > 0
        for i in sorted(owned):
            if state.leaf_states[i] is not None:
                new_states[i] = state.leaf_states[i]
                kept += 1
            elif i in available:
                new_states[i] = self._unflatten_state(available[i], i)
                moved_bytes += sum(int(a.nbytes) for a in available[i])
            else:
                new_states[i] = self._leaf_init(i)
                if had_grid:
                    reinit.append(i)
        if reinit:
            logger.warning(
                "reshard reinitialized %d leaf optimizer states (their "
                "owner left the quorum with them)", len(reinit))
        out = ShardedOptState(n_leaves, world_size=world, rank=my_rank,
                              ranges=ranges, leaf_states=new_states,
                              wire_gen=gen)
        self._state_bytes = float(out.state_bytes())
        metrics = self._metrics()
        if metrics is not None:
            metrics.incr("reshard_count")
            metrics.incr("reshard_moved_bytes", float(moved_bytes))
        ev = getattr(mgr, "events", None)
        if ev:
            ev.emit("reshard", old_world=state.world_size or None,
                    new_world=world, rank=my_rank, moved_bytes=moved_bytes,
                    wire_bytes=wire_bytes, lower_bound_bytes=lower_bound,
                    kept_leaves=kept, reinit_leaves=len(reinit),
                    owned_leaves=len(owned),
                    mesh_shape=f"{world}x{self._model_shards}")
        return out

    # --------------------------------------------------------------- step

    def _leaf_update(self, i: int, grad: np.ndarray):
        """Leaf ``i``'s staged update: ``(new_param, new_state)``, nothing
        adopted."""
        p = self.params[i].detach()
        g = torch.from_numpy(np.ascontiguousarray(grad)).to(
            device=p.device, dtype=p.dtype)
        updates, new_state = self.tx.update([g], self.state.leaf_states[i],
                                            [p])
        return apply_updates([p], updates)[0], new_state

    def step(self, grads: Any = None) -> bool:
        """One sharded step: reduce-scatter the gradients, update this
        rank's leaf shard, run the commit barrier, allgather the updated
        parameters into ``params`` in place. Returns whether the step
        committed; a discarded step changes no parameter and adopts no
        state (a reshard this step persists: it moves states between
        ranks, never along the trajectory)."""
        if isinstance(grads, Future):
            grads = grads.result()
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        mgr = self.manager
        metrics = self._metrics()
        plan, my_rank, red = self._reducer.reduce(list(grads),
                                                  sharded=self._sharded)
        sca = getattr(mgr, "should_commit_async", None)
        if callable(sca):
            decision = sca()
            local_ok = bool(getattr(decision, "local_should_commit", True))
            resolve = decision.result
        else:  # stub managers: a synchronous barrier
            errored = getattr(mgr, "errored", None)
            local_ok = not callable(errored) or errored() is None

            def resolve():
                return bool(mgr.should_commit())
        errored_fn = getattr(mgr, "errored", None)
        if not callable(errored_fn) or errored_fn() is None:
            # never reshard off a failed step's degraded (world 1) view
            before = self.state
            t0 = time.perf_counter()
            self.state = self._maybe_reshard(before, plan, my_rank)
            if self.state is not before and metrics is not None:
                metrics.observe("reshard", time.perf_counter() - t0)
        state = self.state
        owned = (plan.owned_leaves(my_rank) if self._sharded
                 else list(range(len(self.params))))
        staged: Optional[Dict[int, Tuple[torch.Tensor, Any]]] = None
        # a reshard that latched after a True local vote may leave owned
        # leaves without a state: skip the update, the step discards
        if local_ok and set(owned) <= set(red) and all(
                state.leaf_states[i] is not None for i in owned):
            t0 = time.perf_counter()
            with torch.no_grad():
                staged = {i: self._leaf_update(i, red[i]) for i in owned}
            if metrics is not None:
                metrics.observe("opt_update", time.perf_counter() - t0)
                metrics.gauge("opt_update_elems",
                              float(sum(plan.sizes[i] for i in owned)))
        committed = bool(resolve())
        if metrics is not None and self._state_bytes is not None:
            metrics.gauge("opt_state_bytes", self._state_bytes)
        if not committed or staged is None:
            return False
        with torch.no_grad():
            for i, (new_param, new_state) in staged.items():
                state.leaf_states[i] = new_state
                self.params[i].copy_(new_param)
        if not self._sharded or plan.world_size == 1:
            return True
        contrib = [staged[i][0].cpu().numpy() for i in owned]
        gathered = mgr.allgather_arrays(contrib).future().result()
        errored = getattr(mgr, "errored", None)
        if callable(errored) and errored() is not None:
            raise RuntimeError(
                "sharded step committed but the params allgather failed "
                f"({errored()}): this replica cannot materialize the "
                "committed step; restart and heal from a peer")
        with torch.no_grad():
            for shard, (start, stop) in enumerate(plan.ranges):
                if shard == my_rank:
                    continue
                got = gathered[shard]
                if len(got) != stop - start:
                    raise RuntimeError(
                        f"sharded step committed but shard {shard} "
                        f"contributed {len(got)} of {stop - start} leaves; "
                        "restart and heal from a peer")
                for j, i in enumerate(range(start, stop)):
                    self.params[i].copy_(torch.from_numpy(
                        np.asarray(got[j]).reshape(plan.shapes[i])))
        return True

    # ------------------------------------------------------- heal surface
    # A donor's checkpoint carries only its shard, in a fixed structure
    # (zero-length placeholders for the leaves it does not hold), so every
    # donor's manifest aligns slot for slot and is its shard spec
    # (checkpointing.fetch_opt_shard).

    def opt_state_dict(self, state: Optional[ShardedOptState] = None
                       ) -> Dict[str, Any]:
        """``{"spec": {world_size, rank, ranges}, "slots": [[...]]}``: the
        held leaves' state tensors (on the device: a checkpoint server
        stages them lazily) and placeholders elsewhere."""
        state = self.state if state is None else state
        slots: List[List[Any]] = []
        for s in state.leaf_states:
            if s is None:
                slots.append([np.zeros(0, np.float32)] * self._state_slots)
            else:
                slots.append(list(_state_tensors(s)))
        return {"spec": {"world_size": state.world_size, "rank": state.rank,
                         "ranges": [list(r) for r in state.ranges]},
                "slots": slots}

    def load_opt_state_dict(self, sd: Dict[str, Any]) -> ShardedOptState:
        """Adopt a donor's shard as this replica's held states (the grid
        is the donor's, ``wire_gen=None``: the next step's reshard
        redistributes onto the live grid) and return it. Gauges
        ``heal_opt_bytes``, the optimizer bytes the heal moved."""
        spec, slots = sd["spec"], sd["slots"]
        rank = int(spec.get("rank", 0))
        ranges = [tuple(r) for r in spec.get("ranges", [])]
        held = set(range(*ranges[rank])) if rank < len(ranges) else set()
        leaf_states: List[Any] = [None] * len(slots)
        heal_bytes = 0
        for i in sorted(held):
            leaf_states[i] = self._unflatten_state(slots[i], i)
            heal_bytes += sum(int(a.nbytes) for a in slots[i])
        metrics = self._metrics()
        if metrics is not None:
            metrics.gauge("heal_opt_bytes", float(heal_bytes))
            metrics.incr("heal_opt_bytes_total", float(heal_bytes))
        self.state = ShardedOptState(
            len(slots), world_size=int(spec.get("world_size", 0)),
            rank=rank, ranges=ranges, leaf_states=leaf_states, wire_gen=None)
        self._state_bytes = float(self.state.state_bytes())
        return self.state
