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
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from torchft_tpu_torch.utils.metrics import Metrics

__all__ = ["OptimizerWrapper", "load_optimizer_state_dict"]


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
