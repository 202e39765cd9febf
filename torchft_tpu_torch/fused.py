"""The fused HSDP training step over a (replica, model) mesh: one CUDA graph
a step.

Twin of ``torchft_tpu/fused.py``. The HSDP step (params allgather over the
model axis -> per-microbatch grad -> grad reduce-scatter back onto the model
axis -> codec-encoded cross-replica exchange -> sharded optimizer update ->
params allgather over the replica axis) is captured as ONE CUDA graph per
(mesh shape, codec, layouts), so a training step is one replay with zero
host round trips between stages. The staged arm runs the SAME four stage
bodies as four graphs with real host round trips in between: the A/B lever
and the bitwise oracle (both arms replay the same kernels in the same order,
so fused and staged agree bit for bit, not within a tolerance).

The mesh is laid over the ``DevicePool``'s positions (``mesh_for``):
position ``d = r * model_shards + m`` lies on ``pool.devices()[d]``, and
every tensor of the step is one buffer a card holding its positions' rows
in position order. A pool whose positions repeat one card is the virtual
mesh (one stacked ``(D, ...)`` tensor, as the port's other in-group axes
lay theirs); a pool over several cards puts each position on its card, and
a cycled pool holds the positions that share a card as rows of that card's
buffers. On the card a program is one CUDA graph spanning the cards
(``_StepProgram.capture``); across cards the stages copy between them and
stay bitwise the virtual mesh. On the CPU both arms run the same bodies
eagerly, and ``cpu:0 .. cpu:n-1`` lay out as distinct cards.

Counter contract (the reference's):

- ``step_dispatch_count``    +1 per program run (graph replay) — exactly
                             1/step fused, 4/step staged
- ``step_host_hops``         +1 per intermediate device<->host transfer
                             between replays — 0 fused, 6 staged (gm, h and
                             new_sub each cross twice)
- ``step_executable_count``  gauge: programs the last step used (1 / 4)
- ``mesh_shape``             label ``"{replicas}x{model_shards}"``
- ``fused_step``             event per fused step (mesh shape, codec,
                             counts, the program cache's state)

The DevicePool caches one program per (mesh shape, codec, layouts):
``compile_count`` / ``trace_count`` count first sights, ``hit_count`` every
later lookup. Each engine captures a program's graph once over its own state
tensors of that shape (``captures``), so churn back to a seen shape costs no
capture.
"""

from __future__ import annotations

import hashlib
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.comm.cuda_backend import (
    _QUANT_IMPL,
    _STAGES,
    DevicePool,
    _build_fused_step,
    _build_step_stage,
    _Cards,
    _FusedSpec,
    _release_pools,
)
from torchft_tpu_torch.optim import (
    _state_tensors,
    apply_updates,
    state_from_leaves,
    state_leaf_names,
)
from torchft_tpu_torch.utils.metrics import Metrics

__all__ = ["FusedStepEngine", "module_loss_fn", "module_params"]

_CODECS = ("none", "bf16", "fp16", "int8")


def _sub_update(tx: Any, names: Tuple[str, ...]) -> Callable:
    """One position's optimizer step, ``(g, p_sub, leaves) -> (new_sub,
    new_leaves)``: its state rebuilt from the stacked leaves' rows, ``tx``
    and ``apply_updates`` over the owned sub-shard."""

    def update(g: torch.Tensor, p_sub: torch.Tensor,
               leaves: List[torch.Tensor]):
        state = state_from_leaves(names, leaves)
        updates, new_state = tx.update([g], state, [p_sub])
        return apply_updates([p_sub], updates)[0], _state_tensors(new_state)

    return update


Rows = List[torch.Tensor]  # one buffer a card, its positions' rows


class _ShapeState:
    """One mesh shape's tensors on the cards, one buffer a card of its
    positions' rows: the training state (``p``, ``e``, ``opt`` a list of
    leaves), the batch rows, and the staged arm's input buffers and pinned
    host staging (made at its first staged step). The graphs of the shape
    are captured over these tensors, so they live as long as the engine."""

    def __init__(self, p: Rows, e: Rows, opt: List[Rows], b: Rows) -> None:
        self.p, self.e, self.opt, self.b = p, e, opt, b
        self.staged: Optional[Dict[str, Tuple[Rows, Rows]]] = None


class FusedStepEngine:
    """Owns the device-resident training state of one replica-group fleet
    laid out on a ``replicas x model_shards`` mesh and steps it through
    either arm of the A/B.

    Layout (``d = r * model_shards + m``): position ``(r, m)`` holds params
    shard ``m`` (replicated over the replica axis), the error-feedback
    residual of its own encoded contribution, and the optimizer state of
    the sub-shard ``shard_m[r*q_len : (r+1)*q_len]`` it updates. ``params``
    is any flat float32 vector, zero-padded to the mesh-divisible length
    and truncated on the way out.

    ``loss_fn(flat_params, row) -> scalar tensor`` gets a position's
    ``(param_size,)`` view of the gathered params and its batch row; ``tx``
    is an ``optim.OuterTransformation`` (``optim.sgd``/``adamw``). ``fn_key``
    names their identity in the program cache key (two engines with
    different losses must use different keys)."""

    def __init__(
        self,
        device_pool: DevicePool,
        replicas: int,
        model_shards: int,
        params: Any,
        batch_size: int,
        loss_fn: Any,
        tx: Any,
        codec: str = "none",
        chunk_bytes: int = 1 << 16,
        error_feedback: Optional[bool] = None,
        metrics: Optional[Metrics] = None,
        events: Any = None,
        fn_key: str = "default",
    ) -> None:
        if codec not in _CODECS:
            raise ValueError(f"unknown step codec {codec!r}")
        kinds = {d.type for d in device_pool.cards()}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(
                "FusedStepEngine lays its mesh over devices of one kind, "
                "cpu or cuda; this pool's positions lie on "
                f"{', '.join(map(str, device_pool.cards()))}")
        self.pool = device_pool
        self.device = device_pool.devices()[0]  # position 0's: the first card
        self.replicas = int(replicas)
        self.model_shards = max(1, int(model_shards))
        self.codec = codec
        self.tx = tx
        self.loss_fn = loss_fn
        self.metrics = metrics if metrics is not None else Metrics()
        self.events = events
        self.step_count = 0
        self.captures = 0  # CUDA graphs this engine captured
        self._shapes: Dict[Tuple[int, int], _ShapeState] = {}
        self._graphs: Dict[Tuple, Any] = {}
        # on the card: the memory pool and each card's side stream of its
        # captures; the cards besides the first whose allocations a capture
        # routed to the pool, once a capture (released with the engine)
        self._mempool = None
        self._sides: Dict[Tuple[str, int], Any] = {}
        self._routed: List[torch.device] = []
        if error_feedback is None:
            error_feedback = codec == "int8"
        params = torch.as_tensor(np.asarray(params, dtype=np.float32)
                                 .ravel())
        self.spec = self._make_spec(params.numel(), int(batch_size), codec,
                                    int(chunk_bytes), bool(error_feedback),
                                    fn_key)
        self._init_device_state(params)
        self.metrics.label(
            "mesh_shape", f"{self.replicas}x{self.model_shards}"
        )

    # ------------------------------------------------------------ state

    def _make_spec(self, param_size: int, batch_size: int, codec: str,
                   chunk_bytes: int, error_feedback: bool,
                   fn_key: str) -> _FusedSpec:
        """The spec of the current shape; ``tx.init`` on a q_len-shaped
        zero vector gives the optimizer state's leaves and layouts."""
        q_len = max(1, -(-param_size // (self.replicas * self.model_shards)))
        state = self.tx.init([torch.zeros(q_len, dtype=torch.float32)])
        leaves = _state_tensors(state)
        return _FusedSpec(
            replicas=self.replicas,
            model_shards=self.model_shards,
            param_size=param_size,
            batch_size=batch_size,
            codec_name=codec,
            chunk_bytes=chunk_bytes,
            quant_impl=_QUANT_IMPL,
            error_feedback=error_feedback,
            loss_fn=self.loss_fn,
            sub_update=_sub_update(self.tx, state_leaf_names(state)),
            opt_leaf_shapes=[tuple(t.shape) for t in leaves],
            opt_leaf_dtypes=[t.dtype for t in leaves],
            fn_key=fn_key,
        )

    def _init_device_state(self, params: torch.Tensor) -> None:
        """Pad and replicate the flat params into each card's rows, zero
        the residual and initialise each position's optimizer state on its
        card. A shape seen before gets the values written into its tensors,
        so its captured graphs stay valid."""
        spec = self.spec
        R, M = self.replicas, self.model_shards
        self.pool.mesh_for(R, M)  # raises past the pool's positions
        cards = self._cards
        padded = torch.zeros(spec.s_len, dtype=torch.float32,
                             device=self.device)
        padded[:spec.param_size] = params.to(self.device)
        p, e, opt = [], [], []
        for dev, ranks in zip(cards.devices, cards.ranks):
            shards = padded.to(dev).view(M, spec.p_len)
            p.append(shards[torch.as_tensor([d % M for d in ranks],
                                            device=dev)])
            per_pos = []
            for d in ranks:
                r, m = divmod(d, M)
                sub = shards[m, r * spec.q_len:(r + 1) * spec.q_len]
                per_pos.append(_state_tensors(self.tx.init([sub])))
            opt.append([torch.stack([x[i].to(dev) for x in per_pos])
                        .to(spec.opt_leaf_dtypes[i])
                        for i in range(len(per_pos[0]))])
            e.append(torch.zeros((len(ranks), spec.p_len),
                                 dtype=torch.float32, device=dev))
        opt = [list(leaf) for leaf in zip(*opt)]  # by leaf, then card
        st = self._shapes.get((R, M))
        if st is None:
            b = [torch.zeros((len(ranks), spec.batch_size),
                             dtype=torch.float32, device=dev)
                 for dev, ranks in zip(cards.devices, cards.ranks)]
            self._shapes[(R, M)] = _ShapeState(p, e, opt, b)
            return
        for dst, src in zip((st.p, st.e, *st.opt), (p, e, *opt)):
            for d, s in zip(dst, src):
                d.copy_(s)

    @property
    def _state(self) -> _ShapeState:
        return self._shapes[(self.replicas, self.model_shards)]

    @property
    def _cards(self) -> _Cards:
        """Where the current shape's positions lie: one buffer a card."""
        return self.pool.cards_for(self.replicas * self.model_shards)

    @property
    def world_devices(self) -> int:
        return self.replicas * self.model_shards

    def _rows(self, bufs: Rows) -> List[torch.Tensor]:
        """Every position's row of a per-card payload, in position order."""
        cards = self._cards
        return [cards.row(bufs, d) for d in range(cards.n)]

    def _host_rows(self, bufs: Rows) -> np.ndarray:
        """A per-card payload as the stacked ``(D, ...)`` host array of the
        virtual mesh (a copy)."""
        return torch.stack([t.to("cpu") for t in self._rows(bufs)]).numpy()

    def params(self) -> np.ndarray:
        """The full (unpadded) flat param vector, read from the replica-0
        row of each model shard."""
        rows = self._rows(self._state.p)[:self.model_shards]
        full = torch.cat([t.to("cpu", copy=True) for t in rows])
        return full[:self.spec.param_size].numpy()

    def state_tensors(self) -> List[torch.Tensor]:
        """The device state the digest covers, in its order: params, the
        error-feedback residual, the optimizer leaves (optax's order), each
        as its positions' rows in position order: the bytes of the stacked
        layout, wherever the rows lie."""
        st = self._state
        return [t for bufs in (st.p, st.e, *st.opt) for t in self._rows(bufs)]

    def digest(self) -> str:
        """sha256 over all device-resident state (params, EF residual,
        optimizer leaves in the reference's leaf order): the staged <->
        fused bitwise oracle, comparable with the reference engine's."""
        h = hashlib.sha256()
        for t in self.state_tensors():
            h.update(memoryview(np.ascontiguousarray(t.cpu().numpy())))
        return h.hexdigest()

    def verify_replicas(self) -> None:
        """Every replica row of a model shard must hold bitwise-identical
        params (the replica-axis allgather ships raw values, so divergence
        means a broken exchange)."""
        p = [t.view(torch.int32) for t in self._rows(self._state.p)]
        M = self.model_shards
        for m in range(M):
            for r in range(1, self.replicas):
                if not torch.equal(p[m], p[r * M + m].to(p[m].device)):
                    raise AssertionError(
                        f"replica divergence at model shard {m}: "
                        f"replica 0 vs replica {r}"
                    )

    # ------------------------------------------------------------ steps

    def _exe(self, kind: str) -> Any:
        spec = self.spec
        if kind == "fused":
            build = lambda: _build_fused_step(self.pool, spec)  # noqa: E731
        else:
            build = lambda: _build_step_stage(self.pool, spec, kind)  # noqa: E731
        return self.pool.executable(spec.exec_key(kind), build)

    def _side(self, dev: torch.device) -> "torch.cuda.Stream":
        key = (dev.type, dev.index)
        if key not in self._sides:
            self._sides[key] = torch.cuda.Stream(dev)
        return self._sides[key]

    def _run(self, kind: str, args: Tuple[Rows, ...]) -> Tuple:
        """One program run: eager on the CPU; on the card the replay of
        this engine's graph of the program, captured at first sight over
        ``args`` (always the same tensors for a shape) as one graph over
        every card of the shape. A capture that fails raises."""
        prog = self._exe(kind)
        if self.device.type != "cuda":
            return prog.run(*args)
        key = self.spec.exec_key(kind)
        graph = self._graphs.get(key)
        if graph is None:
            if self._mempool is None:
                self._mempool = torch.cuda.graph_pool_handle()
                weakref.finalize(self, _release_pools, self._routed,
                                 self._mempool).atexit = False
            devs = self._cards.devices
            graph = prog.capture(args, self._mempool,
                                 [self._side(d) for d in devs])
            self._routed.extend(devs[1:])
            self._graphs[key] = graph
            self.captures += 1
        return graph.replay()

    def _load_batch(self, batch: Any) -> Rows:
        b = torch.as_tensor(batch, dtype=torch.float32)
        want = (self.world_devices, self.spec.batch_size)
        if tuple(b.shape) != want:
            raise ValueError(
                f"batch shape {tuple(b.shape)} != (devices, batch_size) "
                f"{want}"
            )
        dst = self._state.b
        for t, ranks in zip(dst, self._cards.ranks):
            t.copy_(b[ranks])
        return dst

    def step_fused(self, batch: Any) -> float:
        """ONE program run: the whole step, intermediates never leave the
        device."""
        st = self._state
        b = self._load_batch(batch)
        (loss_row,) = self._run("fused", (st.p, b, st.e, *st.opt))
        self.metrics.incr("step_dispatch_count")
        self.metrics.gauge("step_executable_count", 1)
        self.step_count += 1
        loss = float(loss_row[0])
        ev = self.events
        if ev:
            ev.emit(
                "fused_step",
                step=self.step_count,
                mesh_shape=f"{self.replicas}x{self.model_shards}",
                codec=self.codec,
                dispatches=1,
                executables=1,
                compile_count=self.pool.compile_count,
                trace_count=self.pool.trace_count,
                cache_hits=self.pool.hit_count,
            )
        return loss

    def _staged_buffers(self) -> Dict[str, Tuple[Rows, Rows]]:
        """Per intermediate (gm, h, new_sub) each card's buffer the next
        stage reads and the host staging it crosses (pinned on the card)."""
        st = self._state
        if st.staged is None:
            spec, cards = self.spec, self._cards
            pin = self.device.type == "cuda"
            st.staged = {
                name: ([torch.empty((len(r), n), dtype=torch.float32,
                                    device=dev)
                        for dev, r in zip(cards.devices, cards.ranks)],
                       [torch.empty((len(r), n), dtype=torch.float32,
                                    pin_memory=pin) for r in cards.ranks])
                for name, n in (("gm", spec.p_len), ("h", spec.q_len),
                                ("ns", spec.q_len))
            }
        return st.staged

    def step_staged(self, batch: Any) -> float:
        """FOUR program runs composing the SAME stage bodies, every
        intermediate (gm, h, new_sub) taking a real device -> host -> device
        round trip through host numpy between them: the A/B baseline whose
        state must match :meth:`step_fused` bit for bit."""
        st = self._state
        bufs = self._staged_buffers()
        b = self._load_batch(batch)

        def hop(x: Rows, name: str) -> Rows:
            # every card's rows down to the host and back up
            dev_bufs, hosts = bufs[name]
            for src, dev_buf, host in zip(x, dev_bufs, hosts):
                host.copy_(src)  # d2h, synchronous
                dev_buf.copy_(torch.from_numpy(host.numpy()))  # h2d
            self.metrics.incr("step_host_hops", 2)
            return dev_bufs

        gm, loss_row = self._run("grad", (st.p, b))
        gm = hop(gm, "gm")
        (h,) = self._run("exchange", (gm, st.e))
        h = hop(h, "h")
        (new_sub,) = self._run("update", (h, st.p, *st.opt))
        new_sub = hop(new_sub, "ns")
        self._run("gather", (new_sub, st.p))
        self.metrics.incr("step_dispatch_count", len(_STAGES))
        self.metrics.gauge("step_executable_count", len(_STAGES))
        self.step_count += 1
        return float(loss_row[0])

    def step(self, batch: Any, fused: bool = True) -> float:
        return self.step_fused(batch) if fused else self.step_staged(batch)

    # --------------------------------------------------------- topology

    def reshape_mesh(self, replicas: int,
                     model_shards: Optional[int] = None) -> None:
        """Re-lay the same logical model onto a new mesh shape (the
        heal/churn path): params are read back once and laid out for the
        new shape; a shape seen before reuses its tensors, programs and
        graphs (no capture). The EF residual is dropped (layout-local
        compensation state) and the optimizer state re-initialised, as the
        reference does."""
        params = torch.from_numpy(self.params())
        self.replicas = int(replicas)
        if model_shards is not None:
            self.model_shards = max(1, int(model_shards))
        old = self.spec
        self.spec = self._make_spec(old.param_size, old.batch_size,
                                    old.codec_name, old.chunk_bytes,
                                    old.error_feedback, old.fn_key)
        self._init_device_state(params)
        self.metrics.label(
            "mesh_shape", f"{self.replicas}x{self.model_shards}"
        )

    def counters(self) -> Dict[str, Any]:
        """The counter-oracle snapshot tests and the smoke pin."""
        snap = self.metrics.snapshot()
        return {
            "step_dispatch_count": snap.get("step_dispatch_count", 0),
            "step_host_hops": snap.get("step_host_hops", 0),
            "step_executable_count": snap.get(
                "step_executable_count", 0
            ),
            "mesh_shape": snap.get("mesh_shape", ""),
            "compile_count": self.pool.compile_count,
            "trace_count": self.pool.trace_count,
            "cache_hits": self.pool.hit_count,
            "captures": self.captures,
        }


# ----------------------------------------------------- a module as a loss


class _Bound(torch.nn.Module):
    def __init__(self, module: torch.nn.Module, loss: Callable) -> None:
        super().__init__()
        self.module = module
        self._loss = loss

    def forward(self, row):
        return self._loss(self.module, row)


def module_params(module: torch.nn.Module) -> np.ndarray:
    """``module``'s parameters as one flat float32 vector, in
    ``parameters()`` order: the engine's ``params``."""
    return torch.cat([p.detach().reshape(-1).float().cpu()
                      for p in module.parameters()]).numpy()


def module_loss_fn(module: torch.nn.Module, loss: Callable) -> Callable:
    """The engine's ``loss_fn(flat, row)`` for a module: ``loss(module,
    row)`` with the module's parameters replaced by views of ``flat`` (the
    layout of :func:`module_params`), so autograd reaches ``flat``."""
    from torch.func import functional_call

    bound = _Bound(module, loss)
    named = list(module.named_parameters())
    names = [f"module.{name}" for name, _ in named]
    shapes = [tuple(p.shape) for _, p in named]
    sizes = [p.numel() for _, p in named]

    def loss_fn(flat: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
        # one split: its backward is one concatenation of the gradients
        # (a slice per parameter would fill a zero vector of the whole
        # length per parameter)
        views = {name: t.view(shape) for name, t, shape
                 in zip(names, torch.split(flat, sizes), shapes)}
        return functional_call(bound, views, (row,))

    return loss_fn
