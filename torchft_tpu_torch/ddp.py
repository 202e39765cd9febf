"""Cross-replica gradient averaging over ``nn.Module`` gradients.

Twin of ``DistributedDataParallel`` in ``torchft_tpu/ddp.py``, for torch
modules: after ``loss.backward()``, ``average_gradients(model)`` averages
every parameter's ``.grad`` across replica groups through the Manager
(error-latching) and writes the average back in place.

Gradients are packed into dtype-homogeneous buckets by a plan frozen at the
first call (parameter order, <= ``bucket_bytes`` each), so every replica,
a recovering one included, reduces identical buckets. Each bucket has a
step-persistent host staging buffer (pinned when the gradients live on a
GPU): the gradients are copied device -> host into it, the transport reduces
in place into it (the comm donation contract), the Manager scales it by
1/num_participants, and it is copied host -> device back into ``.grad``.
Healing replicas contribute zeros and receive the average, which is how
they end the heal step bitwise identical to their donor.

With no data-plane peer (a solo wire) the average is an identity and the
copies are skipped; the quorum still runs.

Error feedback (the reference's ``error_feedback="auto"``): when this
rank's contribution crosses the wire through a lossy codec
(``manager.wire_compensable()``, role-aware: a star peer, or every rank of
the quantized psum) and this replica contributes real gradients, each f32
bucket carries a residual e: the bucket ships g + e and keeps
e = (g + e) - C(g + e), C being the wire's own image of one contribution
(``manager.wire_roundtrip``). The residuals reset to zero whenever the
transport reconfigures (``wire_generation`` changes). Over
``topology="hier"`` the gate is role-aware by itself: only an egress rank
whose domain sum crosses the inter tier encoded is compensable, and its
residual is that of its own contribution. This is the reference's
lock-step path; its streamed pipeline is not ported.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["DistributedDataParallel"]

_DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024


def _ef_dtype(dt: np.dtype) -> bool:
    """Buckets the wire codecs compress (transport ``_is_compressible``):
    integer buckets pass losslessly and carry no residual."""
    return dt in (np.float32, np.float64)


def _ef_gate(manager, error_feedback: "bool | str" = "auto") -> bool:
    """The error-feedback activation rule: enabled, AND (under "auto") this
    rank's contribution crosses the wire through a lossy codec, AND this
    replica contributes real values this step (a healing or spare replica
    ships zeros, whose "error" would bank the whole gradient).
    ``error_feedback=True`` forces it on; False turns it off."""
    if error_feedback is False:
        return False
    if error_feedback == "auto" and not manager.wire_compensable():
        return False
    return bool(manager.is_participating())


class _BucketPlan:
    """Fixed mapping of parameter indices into dtype-homogeneous buckets,
    built from shapes and dtypes only; order within a dtype follows the
    parameter order, so it is identical on every replica."""

    def __init__(self, params: Sequence[torch.Tensor],
                 bucket_bytes: int) -> None:
        self.shapes = [tuple(p.shape) for p in params]
        self.dtypes = [p.dtype for p in params]
        self.sizes = [p.numel() for p in params]
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, dt in enumerate(self.dtypes):
            by_dtype.setdefault(dt, []).append(i)
        self.buckets: List[List[int]] = []
        for dt, indices in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
            current: List[int] = []
            current_bytes = 0
            itemsize = torch.empty((), dtype=dt).element_size()
            for i in indices:
                nbytes = self.sizes[i] * itemsize
                if current and current_bytes + nbytes > bucket_bytes:
                    self.buckets.append(current)
                    current, current_bytes = [], 0
                current.append(i)
                current_bytes += nbytes
            if current:
                self.buckets.append(current)

    def signature(self) -> Tuple:
        return tuple(zip(self.shapes, self.dtypes))

    def alloc_staging(self, pin: bool) -> List[torch.Tensor]:
        return [
            torch.empty(sum(self.sizes[i] for i in bucket),
                        dtype=self.dtypes[bucket[0]], pin_memory=pin)
            for bucket in self.buckets
        ]

    def slices(self, k: int):
        """``(param index, offset, size)`` of bucket k's slices."""
        offset = 0
        for i in self.buckets[k]:
            yield i, offset, self.sizes[i]
            offset += self.sizes[i]


class DistributedDataParallel:
    """Bucketed fault-tolerant gradient averager. ``error_feedback``:
    "auto" (a residual exactly where this rank's contribution crosses a
    lossy codec), True or False. ``topology``: the data path of every
    bucket's allreduce ("flat"/"hier"; None passes no override)."""

    def __init__(self, manager,
                 bucket_bytes: int = _DEFAULT_BUCKET_BYTES,
                 error_feedback: "bool | str" = "auto",
                 topology: Optional[str] = None) -> None:
        if error_feedback not in (True, False, "auto"):
            raise ValueError(f"error_feedback must be True/False/'auto', "
                             f"got {error_feedback!r}")
        self._manager = manager
        self._bucket_bytes = bucket_bytes
        self._error_feedback = error_feedback
        # passed only when set, so managers without the keyword work
        self._ar_kwargs = {} if topology is None else {"topology": topology}
        self._plan: "_BucketPlan | None" = None
        self._staging: "List[torch.Tensor] | None" = None
        # per-bucket residuals (None for buckets the codecs pass raw) and
        # the wire generation they describe
        self._residuals: "Optional[List[Optional[np.ndarray]]]" = None
        self._ef_generation: Optional[int] = None

    def bucket_sizes(self) -> List[int]:
        """Element counts of the frozen plan's buckets (empty before the
        first average): one allreduce each per step with a wire peer."""
        if self._plan is None:
            return []
        return [sum(self._plan.sizes[i] for i in b)
                for b in self._plan.buckets]

    def _grads(self, params: Sequence[torch.nn.Parameter]) -> List[torch.Tensor]:
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        return grads

    def _get_plan(self, grads: List[torch.Tensor]) -> _BucketPlan:
        if self._plan is None:
            self._plan = _BucketPlan(grads, self._bucket_bytes)
            self._staging = self._plan.alloc_staging(
                pin=grads[0].is_cuda if grads else False
            )
        elif tuple((tuple(g.shape), g.dtype) for g in grads) \
                != self._plan.signature():
            raise ValueError(
                "gradient shapes/dtypes changed between steps; the DDP "
                "bucket layout is frozen by design"
            )
        return self._plan

    def average_gradients(self, model: "torch.nn.Module | Sequence") -> None:
        """Average the ``.grad`` of every parameter of ``model`` (a module
        or a sequence of parameters) across replica groups, in place.
        Blocking. On a transport error the error is latched and the
        gradients are UNSPECIFIED; the commit gate then discards the step.
        """
        params = (list(model.parameters())
                  if isinstance(model, torch.nn.Module) else list(model))
        try:
            self._manager.wait_quorum()
        except Exception as e:  # noqa: BLE001 — latch so the step discards
            self._manager.report_error(e)
            return
        if self._manager.is_solo_wire() or not params:
            return
        grads = self._grads(params)
        plan = self._get_plan(grads)
        staging = self._staging
        metrics = self._manager.metrics
        sync = grads[0].is_cuda
        with metrics.timed("ddp_d2h"):
            for k in range(len(plan.buckets)):
                for i, off, n in plan.slices(k):
                    staging[k][off: off + n].copy_(
                        grads[i].reshape(-1), non_blocking=True
                    )
            if sync:
                torch.cuda.current_stream(grads[0].device).synchronize()
        buckets = [s.numpy() for s in staging]
        if _ef_gate(self._manager, self._error_feedback):
            residuals = self._ef_arena(buckets)
            with metrics.timed("ddp_ef"):
                for packed, res in zip(buckets, residuals):
                    if res is not None:
                        np.add(packed, res, out=packed)
                        self._ef_residual(packed, res)
        works: List[Future] = [
            self._manager.allreduce_arrays([b], **self._ar_kwargs).future()
            for b in buckets
        ]
        with metrics.timed("ddp_wire"):
            # the reduced bucket is the staging buffer itself, or (while
            # healing) the zeros the Manager contributed in its place
            reduced = [torch.from_numpy(w.result()[0]) for w in works]
        with metrics.timed("ddp_h2d"):
            for k, src in enumerate(reduced):
                for i, off, n in plan.slices(k):
                    grads[i].view(-1).copy_(src[off: off + n],
                                            non_blocking=True)
            if sync:
                # the next step's D2H and host-side reduce reuse staging
                torch.cuda.current_stream(grads[0].device).synchronize()

    def _ef_arena(self, buckets: List[np.ndarray]
                  ) -> "List[Optional[np.ndarray]]":
        """The residuals, zeroed on first use and whenever the transport
        reconfigured: a new membership's wire made none of the old
        error."""
        gen = self._manager.wire_generation()
        if self._residuals is None or gen != self._ef_generation:
            self._residuals = [np.zeros_like(b) if _ef_dtype(b.dtype)
                               else None for b in buckets]
            self._ef_generation = gen
        return self._residuals

    def _ef_residual(self, transmitted: np.ndarray, res: np.ndarray) -> None:
        """e = g' - C(g'), with g' the contribution about to be donated to
        the wire (reduced in place after submit, so computed before)."""
        self._manager.wire_roundtrip(transmitted, res)  # res = C(g')
        np.subtract(transmitted, res, out=res)
        if not np.all(np.isfinite(res)):
            # a non-finite gradient poisons its wire image and the step is
            # discarded, but the residual persists: drop that error rather
            # than re-inject the spike into every later step
            np.nan_to_num(res, copy=False, nan=0.0, posinf=0.0, neginf=0.0)
