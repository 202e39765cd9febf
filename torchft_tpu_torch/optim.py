"""Commit-gated optimizer wrapper.

Twin of ``OptimizerWrapper`` in ``torchft_tpu/optim.py``, in the reference
torchft shape over a ``torch.optim.Optimizer``: ``begin_step`` (alias
``zero_grad``) starts the quorum and clears the gradients; ``step()`` runs
``optimizer.step()`` only if the replica group commits, and returns whether
it did.

Two paths, as in the reference:

- classic (``step``): decide, then apply. Torch updates in place, which is
  the reference's ``donate_update=True`` arm: the commit barrier runs
  first and a discarded step touches nothing. (The reference's default
  overlapped arm dispatches the update beside the barrier RPC and drops it
  on a discard; in torch that needs a second copy of parameters and
  optimizer state, and is not ported.)
- fused (``can_fuse`` -> ``fused_step``): on a solo wire the average is an
  identity, so the barrier runs first and then one fused forward +
  backward + update, a CUDA graph on the card (``models.make_train_step``).

A heal applies the donor's state through the user's ``load_state_dict``
inside the barrier, into the very tensors this optimizer holds, so the
committed update lands on the healed state. ``fused_step`` then has the
fused function re-read the state (``sync_state``), so a load that replaced
tensors makes the graph re-capture.

The fence bounds how far the host runs ahead of the card: each committed
step pushes an entry (a CUDA event, and the step's loss), and the entry from
``fence_depth`` steps ago is waited out. Fused-path entries are read back
``fence_stride`` at a time in one ``torch.stack(...).cpu()``; a classic
entry waits its event at once. Every non-committing step drains the fence.
The losses read back land in ``take_losses()``, keyed by the step count
after the commit. ``metrics`` times ``prologue``, ``barrier``,
``dispatch``, ``fence`` and ``transition_drain`` over every step, the
reference's names; ``fused_metrics`` the same phases of fused steps alone.

DiLoCo's outer optimizer (local_sgd.py) must stage a step and adopt it only
if the round commits, which ``torch.optim.Optimizer`` (it updates in place)
cannot. So it runs on :class:`OuterTransformation`, a functional
transformation in optax's shape and order of operations (``sgd`` with
optional momentum and Nesterov, ``adam``), partitioned per fragment by
:class:`PartitionedOuterOptimizer`.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.utils.metrics import Metrics

__all__ = ["OptimizerWrapper", "OuterTransformation",
           "PartitionedOuterOptimizer", "adam", "apply_updates",
           "from_optax_state", "load_optimizer_state_dict", "sgd"]


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


class OptimizerWrapper:
    """Gates ``optimizer.step()`` on the manager's two-phase commit."""

    def __init__(self, manager, optimizer: torch.optim.Optimizer,
                 fence_depth: int = 1, fence_stride: int = 8) -> None:
        self.manager = manager
        self.optimizer = optimizer
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

    @contextmanager
    def _fused_timed(self, name: str) -> Iterator[None]:
        """Time a fused step's phase into both sinks."""
        with self.metrics.timed(name), self.fused_metrics.timed(name):
            yield

    def begin_step(self, **kwargs) -> None:
        """Start the (async) quorum and clear the gradients — call before
        the forward pass."""
        self.manager.start_quorum(**kwargs)
        self.optimizer.zero_grad(set_to_none=False)

    zero_grad = begin_step

    # ----------------------------------------------------------- classic

    def step(self, loss: Optional[torch.Tensor] = None) -> bool:
        """Apply the update iff the replica group commits this step.
        ``loss`` (optional) is read back through the fence."""
        self.classic_steps += 1
        with self.metrics.timed("prologue"):
            decision = self.manager.should_commit_async()
        try:
            with self.metrics.timed("barrier"):
                committed = bool(decision.result())
        except BaseException:
            self._drain_fence()
            raise
        if committed:
            with self.metrics.timed("dispatch"):
                self.optimizer.step()
            with self.metrics.timed("fence"):
                self._push_fence("block", loss)
            return True
        self._drain_fence()
        return False

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
                 eps: float = 1e-8) -> None:
        self.kind = kind
        self.learning_rate = float(learning_rate)
        self.momentum = momentum
        self.nesterov = nesterov
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, leaves: Sequence[torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: [torch.zeros_like(x) for x in leaves]  # noqa: E731
        if self.kind == "adam":
            return {"count": torch.zeros((), dtype=torch.int32),
                    "mu": zeros(), "nu": zeros()}
        if self.momentum is not None:
            return {"trace": zeros()}
        return {}

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        del params  # neither transformation reads them (optax's too)
        new_state: Dict[str, Any] = {}
        if self.kind == "adam":
            b1, b2 = self.b1, self.b2
            # (1 - decay) * g**order + decay * t, then the bias correction
            # 1 - decay**count in f32, as optax computes them
            mu = [g * (1 - b1) + t * b1 for g, t in zip(grads, state["mu"])]
            nu = [(g * g) * (1 - b2) + t * b2
                  for g, t in zip(grads, state["nu"])]
            count = state["count"] + 1
            c = count.to(torch.float32)
            bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
            bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c
            updates = [(m / bc1.to(m.dtype))
                       / (torch.sqrt(v / bc2.to(v.dtype)) + self.eps)
                       for m, v in zip(mu, nu)]
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
