"""Pipeline parallelism: microbatched stages over a mesh axis.

Twin of ``torchft_tpu/parallel/pipeline.py``. Every parameter leaf is
stacked with a leading ``num_stages`` dim split over the ``stage`` axis
(a ``ShardedTensor`` of spec ``PartitionSpec("stage", ...)``, so each
position holds exactly its stage's weights, or a plain stacked tensor);
microbatches flow stage 0 -> S-1.

The reference runs one stage per device under ``shard_map``: a
``fori_loop`` of compute and ``ppermute`` hops that runs ``stage_fn`` on
every position at every tick and masks the bubble away. Here the stage
positions run in lock-step in one process, each on its coordinate's
device (``Mesh.axis_devices``), and only the slots the schedule fills run
``stage_fn`` (the outputs are the same). A hop moves each position's
output to its successor's device (``parallel.ring._rotate``, the ring's
``ppermute(i -> i + 1)``); on a virtual mesh (one card repeated) it moves
no bytes.

- :func:`make_pipeline`: the GPipe forward ``(stacked, microbatches) ->
  outputs``, differentiable by autograd (the reference differentiates it
  with ``jax.grad``): ``loss.backward()`` through it is the reverse
  pipeline, and it keeps every microbatch's activations, as the
  reference's transpose does.
- :func:`make_pipeline_1f1b` and :func:`make_pipeline_interleaved_1f1b`:
  explicit training schedules ``(stacked, x_mb, y_mb) -> (mean_loss,
  stacked_param_grads)`` driven by ``parallel/schedule.py``'s tables. A
  forward slot runs the stage without a graph and stores its input; a
  backward slot recomputes the stage under ``torch.enable_grad()`` from
  that input and takes ``torch.autograd.grad`` for the stage's parameters
  and its input (the last virtual stage seeds it with ``d loss_fn``).
  Parameter gradients sum in tick order and are divided by M at the end.

    mesh = ft_mesh({"stage": 4}, devices=["cuda"] * 4)
    stacked = stack_stage_params([p0, p1, p2, p3])
    pp = make_pipeline(mesh, stage_fn)     # stage_fn(stage_params, h) -> h
    out = pp(stacked, microbatches)        # [M, mb, ...] -> [M, mb, ...]
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from torchft_tpu_torch.parallel.ring import _rotate
from torchft_tpu_torch.parallel.schedule import (
    interleaved_tables,
    one_f_one_b_schedule,
)
from torchft_tpu_torch.parallel.sharding import ShardedTensor, _device

__all__ = ["make_pipeline", "make_pipeline_1f1b",
           "make_pipeline_interleaved_1f1b", "stack_stage_params",
           "stack_interleaved_params", "split_microbatches",
           "merge_microbatches"]


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (``rest``:
    trees of the same structure, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def _leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


def _stack(leaves) -> torch.Tensor:
    return torch.stack([torch.as_tensor(leaf) for leaf in leaves])


def stack_stage_params(stage_params_list) -> Any:
    """Stack per-stage param trees into one tree with a leading
    num_stages dim (split it over the stage axis with
    ``PartitionSpec("stage", ...)``)."""
    return _tree_map(lambda *leaves: _stack(leaves), *stage_params_list)


def stack_interleaved_params(stage_params_list, num_stages: int,
                             interleave: int):
    """Stack V*S virtual-stage param trees (virtual-stage order: list
    index v, where v = chunk*S + device) into one tree with a leading
    [S*V] dim in DEVICE-MAJOR order (row s*V + c = virtual stage c*S + s),
    so splitting the leading dim over the stage axis hands position s
    exactly its V chunks, c-indexed."""
    S, V = num_stages, interleave
    if len(stage_params_list) != S * V:
        raise ValueError(f"{len(stage_params_list)} virtual stages, want "
                         f"{S} x {V}")
    device_major = [
        stage_params_list[c * S + s] for s in range(S) for c in range(V)
    ]
    return _tree_map(lambda *leaves: _stack(leaves), *device_major)


def split_microbatches(x, num_microbatches: int):
    """[B, ...] -> [M, B/M, ...]"""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by {num_microbatches} "
                         f"microbatches")
    return x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])


def merge_microbatches(x):
    """[M, mb, ...] -> [M*mb, ...]"""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


class _StageAxis:
    """The ``axis`` of a mesh as the runners see it: its size, each
    coordinate's device and flat mesh position (the other axes at 0)."""

    def __init__(self, mesh, axis: str) -> None:
        mesh = getattr(mesh, "mesh", None) or mesh
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
        self.size = mesh.shape[axis]
        self.devices = [_device(d) for d in mesh.axis_devices(axis)]
        i = mesh.axis_names.index(axis)
        grid = mesh.devices.shape
        self.positions = []
        for s in range(self.size):
            coord = [0] * len(grid)
            coord[i] = s
            self.positions.append(int(np.ravel_multi_index(coord, grid)))

    def row_params(self, stacked: Any, s: int, row: int) -> Any:
        """Row ``row`` of every stacked leaf as stage ``s``'s position
        holds it: a view of the position's piece of a ``ShardedTensor``
        (autograd reaches the piece), or the row of a plain tensor moved
        to the position's device."""

        def pick(leaf):
            if isinstance(leaf, ShardedTensor):
                j = leaf._index[self.positions[s]]
                lo, hi = leaf.bounds[j][0]
                if not lo <= row < hi:
                    raise ValueError(
                        f"stage {s}'s piece holds rows [{lo}, {hi}) of a "
                        f"{leaf.shape} leaf, not row {row}: split the "
                        f"leading dim over the stage axis")
                return leaf.pieces[j][row - lo]
            return leaf[row].to(self.devices[s])

        return _tree_map(pick, stacked)

    def stack_grads(self, stacked: Any, grads: Dict[int, List[torch.Tensor]]
                    ) -> Any:
        """The gradient of every stacked leaf in its own layout, from each
        row's gradients (``grads[row]``, one per leaf in leaf order)."""
        index = iter(range(len(_leaves(stacked))))

        def build(leaf):
            i = next(index)
            if isinstance(leaf, ShardedTensor):
                return leaf.like([
                    torch.stack([grads[r][i].to(dev) for r in range(lo, hi)])
                    for ((lo, hi), *_), dev in zip(leaf.bounds,
                                                   leaf.devices)])
            return torch.stack([grads[r][i].to(leaf.device)
                                for r in range(leaf.shape[0])])

        return _tree_map(build, stacked)


def make_pipeline(mesh, stage_fn: Callable[[Any, Any], Any],
                  axis: str = "stage",
                  embed_fn: Optional[Callable[[Any], Any]] = None,
                  readout_fn: Optional[Callable[[Any], Any]] = None):
    """Build the pipelined apply: ``(stacked_params, microbatches) ->
    outputs``, where ``stage_fn(params_for_one_stage, h)`` is one stage's
    compute and microbatches is [M, mb, ...]. GPipe's schedule: at tick t
    stage s runs microbatch t - s. Differentiable: autograd through it is
    the reverse pipeline.

    ``embed_fn`` (stage 0 only) maps a raw input microbatch to the hidden
    representation, and ``readout_fn`` maps the last stage's hidden state
    to the output (token ids in, logits out, hidden states between
    stages); ``stage_fn`` maps hidden -> hidden. The outputs are the last
    stage's, put on the microbatches' device."""
    ax = _StageAxis(mesh, axis)
    S, devices = ax.size, ax.devices

    def pipeline(stacked_params, x):
        M = x.shape[0]
        params = [ax.row_params(stacked_params, s, s) for s in range(S)]
        held: List[list] = [[] for _ in range(S)]
        outs: List[Optional[torch.Tensor]] = [None] * M
        for t in range(M + S - 1):
            sent: List[list] = []
            for s in range(S):
                k = t - s
                if not 0 <= k < M:
                    sent.append([])
                    continue
                if s == 0:
                    h = x[k].to(devices[0])
                    h = embed_fn(h) if embed_fn is not None else h
                else:
                    h = held[s][0]
                h = stage_fn(params[s], h)
                if s == S - 1:
                    outs[k] = h
                    sent.append([])
                else:
                    sent.append([h])
            held = _rotate(sent, devices)
        out = [o.to(x.device) for o in outs]
        if readout_fn is not None:
            out = [readout_fn(o) for o in out]
        return torch.stack(out)

    return pipeline


_TABLES = ("f_mb", "f_chunk", "f_src", "f_act", "f_stash",
           "b_mb", "b_chunk", "b_act", "b_gsrc", "b_stash")


def _one_f_one_b_tables(num_stages: int,
                        num_microbatches: int) -> Dict[str, Any]:
    """``one_f_one_b_schedule`` lowered to :func:`interleaved_tables`'s
    per-tick tables (one chunk a position): a stage's input is stored at
    activation slot ``mb % S``, and a value arriving from a neighbour is
    consumed on the tick it lands, so each channel has one slot."""
    S, M = num_stages, num_microbatches
    sched = one_f_one_b_schedule(S, M)
    T = len(sched)
    out = {name: [[-1] * S for _ in range(T)] for name in _TABLES}
    for t, row in enumerate(sched):
        for s, action in enumerate(row):
            if action is None:
                continue
            phase, mb, _ = action
            if phase == "F":
                out["f_mb"][t][s], out["f_chunk"][t][s] = mb, 0
                out["f_src"][t][s] = -1 if s == 0 else 0
                out["f_act"][t][s] = mb % S
                if s > 0:
                    out["f_stash"][t][s] = 0
            else:
                out["b_mb"][t][s], out["b_chunk"][t][s] = mb, 0
                out["b_act"][t][s] = mb % S
                out["b_gsrc"][t][s] = -1 if s == S - 1 else 0
                if s < S - 1:
                    out["b_stash"][t][s] = 0
    out.update(n_fwd_slots=1, n_bwd_slots=1, n_act_slots=min(S, M), ticks=T)
    return out


def _run_tables(ax: _StageAxis, tables: Dict[str, Any], interleave: int,
                stage_fn, loss_fn, embed_fn, num_microbatches: int, stats):
    """The runner both 1F1B schedules share: ``(stacked, x, y) ->
    (mean_loss, stacked_param_grads)`` following ``tables`` slot by slot
    (:func:`interleaved_tables`'s format)."""
    S, V, M = ax.size, interleave, num_microbatches
    devices, T = ax.devices, tables["ticks"]
    total_v = S * V
    tab = {n: tables[n] for n in _TABLES}

    def run(stacked_params, x, y):
        if x.shape[0] != M or y.shape[0] != M:
            raise ValueError(f"{x.shape[0]} / {y.shape[0]} microbatches, "
                             f"the schedule has {M}")
        # each chunk's parameters as leaves of their own: the backward
        # slots take their gradients, the caller's tensors stay untouched
        params = [[[leaf.detach().requires_grad_(True) for leaf in
                    _leaves(ax.row_params(stacked_params, s, s * V + c))]
                   for c in range(V)] for s in range(S)]
        fwd_buf = [[None] * tables["n_fwd_slots"] for _ in range(S)]
        bwd_buf = [[None] * tables["n_bwd_slots"] for _ in range(S)]
        acts = [[None] * tables["n_act_slots"] for _ in range(S)]
        grads: List[List[Optional[List[torch.Tensor]]]] = [
            [None] * V for _ in range(S)]
        loss_acc = None
        h_held: List[list] = [[] for _ in range(S)]
        g_held: List[list] = [[] for _ in range(S)]
        peak = 0

        def chunk(leaves):
            # the stacked tree's structure over one chunk's leaves
            i = iter(leaves)
            return _tree_map(lambda _: next(i), stacked_params)

        def arrived(held, s, t, what):
            if not held[s]:
                raise RuntimeError(f"tick {t}: stage {s} expects a {what} "
                                   f"that never arrived")
            return held[s][0]

        for t in range(T):
            h_out: List[list] = [[] for _ in range(S)]
            g_out: List[list] = [[] for _ in range(S)]
            for s in range(S):
                if tab["f_stash"][t][s] >= 0:
                    fwd_buf[s][tab["f_stash"][t][s]] = arrived(
                        h_held, s, t, "forward value")
                if tab["b_stash"][t][s] >= 0:
                    bwd_buf[s][tab["b_stash"][t][s]] = arrived(
                        g_held, s, t, "cotangent")
                mb = tab["f_mb"][t][s]
                if mb >= 0:
                    c, src = tab["f_chunk"][t][s], tab["f_src"][t][s]
                    if src < 0:
                        h_in = x[mb].to(devices[s])
                        if embed_fn is not None:
                            h_in = embed_fn(h_in)
                    else:
                        h_in = fwd_buf[s][src]
                        fwd_buf[s][src] = None
                    h_in = h_in.detach()
                    with torch.no_grad():
                        h_out[s] = [stage_fn(chunk(params[s][c]), h_in)]
                    slot = tab["f_act"][t][s]
                    if acts[s][slot] is not None:
                        raise RuntimeError(f"tick {t}: stage {s} activation "
                                           f"slot {slot} is taken")
                    acts[s][slot] = h_in
                    peak = max(peak, sum(a is not None for a in acts[s]))
                mb = tab["b_mb"][t][s]
                if mb >= 0:
                    c, slot = tab["b_chunk"][t][s], tab["b_act"][t][s]
                    gsrc = tab["b_gsrc"][t][s]
                    a_in, acts[s][slot] = acts[s][slot], None
                    first = c * S + s == 0
                    leaves = params[s][c]
                    with torch.enable_grad():
                        a = a_in.detach().requires_grad_(not first)
                        out = stage_fn(chunk(leaves), a)
                        wrt = leaves + ([] if first else [a])
                        if gsrc < 0:
                            loss_k = loss_fn(out, y[mb].to(devices[s]))
                            got = torch.autograd.grad(loss_k, wrt,
                                                      allow_unused=True)
                            loss_k = loss_k.detach()
                            loss_acc = loss_k if loss_acc is None \
                                else loss_acc + loss_k
                        else:
                            g_in, bwd_buf[s][gsrc] = bwd_buf[s][gsrc], None
                            got = torch.autograd.grad(out, wrt, g_in,
                                                      allow_unused=True)
                    pg = [torch.zeros_like(p) if g is None else g
                          for p, g in zip(leaves, got)]
                    prev = grads[s][c]
                    grads[s][c] = pg if prev is None else [
                        a + b for a, b in zip(prev, pg)]
                    if not first:
                        g_out[s] = [torch.zeros_like(a) if got[-1] is None
                                    else got[-1]]
            h_held = _rotate(h_out, devices)
            g_held = _rotate(g_out, devices, shift=-1)
        stats["peak_inflight"] = peak
        rows = {s * V + c: [g / M for g in grads[s][c]]
                for s in range(S) for c in range(V)}
        if loss_acc is None or len(rows) != total_v:
            raise RuntimeError("the schedule ran no backward slot")
        return (loss_acc / M).to(x.device), ax.stack_grads(stacked_params,
                                                           rows)

    return run


def make_pipeline_1f1b(mesh, stage_fn: Callable[[Any, Any], Any],
                       loss_fn: Callable[[Any, Any], Any],
                       num_microbatches: int,
                       axis: str = "stage",
                       embed_fn: Optional[Callable[[Any], Any]] = None):
    """Explicit 1F1B training pipeline: ``(stacked_params, x_mb, y_mb) ->
    (mean_loss, stacked_param_grads)``.

    Unlike ``make_pipeline`` + ``backward()`` (which runs the whole
    forward schedule before any backward), this follows
    ``one_f_one_b_schedule``: each stage starts backwards as soon as its
    first microbatch returns from the last stage, so a position stores at
    most S stage inputs (slot ``mb % S``) instead of M. ``loss_fn(h_last,
    y_mb) -> scalar`` plays the readout role on the last stage (its
    gradient seeds the backward); ``embed_fn`` (stage 0) lifts raw inputs
    to the hidden shape. The backward recomputes each stage's forward from
    its stored input. After a call, the returned function's
    ``stats["peak_inflight"]`` holds the most stage inputs one position
    stored at once."""
    ax = _StageAxis(mesh, axis)
    stats: Dict[str, int] = {}
    run = _run_tables(ax, _one_f_one_b_tables(ax.size, num_microbatches), 1,
                      stage_fn, loss_fn, embed_fn, num_microbatches, stats)
    run.stats = stats
    return run


def make_pipeline_interleaved_1f1b(
    mesh, stage_fn: Callable[[Any, Any], Any],
    loss_fn: Callable[[Any, Any], Any],
    num_microbatches: int,
    interleave: int,
    axis: str = "stage",
    embed_fn: Optional[Callable[[Any], Any]] = None,
):
    """Executable interleaved 1F1B (Megatron-style virtual stages):
    ``(stacked_params, x_mb, y_mb) -> (mean_loss, stacked_param_grads)``.

    Each position owns ``interleave`` model chunks (params stacked
    device-major by :func:`stack_interleaved_params`); microbatches
    traverse all V*S virtual stages, and the hop v -> v+1 is always
    position s -> (s+1) % S. The greedy interleaved schedule does not align
    a producer's send with its consumer's slot, so values park in
    per-position buffers whose slots ``schedule.interleaved_tables``
    assigns; this runner follows those tables tick by tick. ``stats`` as
    :func:`make_pipeline_1f1b`'s."""
    ax = _StageAxis(mesh, axis)
    stats: Dict[str, int] = {}
    run = _run_tables(ax, interleaved_tables(ax.size, num_microbatches,
                                             interleave),
                      interleave, stage_fn, loss_fn, embed_fn,
                      num_microbatches, stats)
    run.stats = stats
    return run

