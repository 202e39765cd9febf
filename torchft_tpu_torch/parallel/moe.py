"""Expert parallelism: a capacity-based top-2 MoE feed-forward block.

Twin of ``torchft_tpu/parallel/moe.py``: the GShard formulation. Routing
builds dense ``[tokens, experts, capacity]`` dispatch and combine tensors
and four einsums move tokens to their experts and back, with static shapes
(the capacity bounds the routing). Tokens past an expert's capacity are
dropped (they pass through the residual). The routing runs in f32, the
expert products in ``cfg.dtype``; the GELU is the tanh approximation
(``jax.nn.gelu``'s default).

Expert parallelism: ``moe_rules()`` (the reference's rules) cut the
experts' ``up`` and ``down`` on their expert dimension over the mesh's
``expert`` axis and keep the router whole. The reference lets XLA insert
the all-to-alls; here the mesh's positions run in lock-step in one process
(as ``models.transformer.ShardedGPT`` runs them), each on its batch shard
(the tokens split over the ``data`` x ``expert`` coordinates, GShard's
layout), and :func:`sharded_moe_forward` moves the tokens explicitly:

- the routing stays global, as the reference's over the whole batch: the
  capacity counts every token, and each shard's queue positions start
  after the earlier shards' (their per-expert counts of first and second
  choices, summed in shard order; second choices after every first
  choice), so the same tokens drop;
- dispatch: each position's ``[E, C, D]`` expert inputs of its own tokens,
  summed over the positions of its row (those differing on the expert axis
  alone) into each position's own experts (``_ExpertExchange``, the
  all-to-all). A capacity slot holds one token at most, so the sum is exact;
- combine: each position gathers its row's expert outputs in expert order
  (``_ExpertGather``) and combines its tokens' two choices as the
  unsharded block does, up to the order of the sum;
- the load-balancing loss from global sums, never a mean of shard means.

    params = init_moe_params(cfg, seed=0)
    y, aux_loss = moe_forward(cfg, params, x)
    sharded = shard_pytree(params, mesh, moe_rules(), fsdp_axis=None)
    y, aux_loss = moe_forward_sharded(cfg, sharded, x)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torchft_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_EXPERT
from torchft_tpu_torch.utils.device import resolve_device

__all__ = ["ExpertPlan", "MoEConfig", "init_moe_params", "moe_forward",
           "moe_forward_sharded", "moe_rules", "sharded_moe_forward"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    capacity_factor: float = 1.25
    dtype: Optional[torch.dtype] = None  # default: x.dtype


def init_moe_params(cfg: MoEConfig, seed: int = 0, device=None
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """f32 parameters in the reference's layout and scales: the router
    ``gate/kernel`` [D, E] and the experts' ``up`` [E, D, F] and ``down``
    [E, F, D], drawn from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    gate = torch.randn((d, e), generator=gen) / d ** 0.5
    up = torch.randn((e, d, f), generator=gen) / d ** 0.5
    down = torch.randn((e, f, d), generator=gen) / f ** 0.5
    dev = resolve_device(device)
    return {"gate": {"kernel": gate.to(dev)},
            "experts": {"up": up.to(dev), "down": down.to(dev)}}


def moe_rules():
    """Path rules sharding expert weights on the ``expert`` axis (the
    reference's, word for word). The rules carry their mesh axis (3-tuples,
    ``parallel.sharding.TpRule``), so they compose with ``tp_rules_gpt()``
    in one ``shard_pytree`` pass: attention on "tensor", experts on
    "expert"."""
    return [
        (r".*experts/(up|down)", 0, "expert"),   # expert dim
        (r".*gate/kernel", None, "expert"),      # router replicated
        # (gate pattern is anchored so a transformer's gate_proj still gets
        # its TP rule when rule lists merge)
    ]


def _top2_masks(gates: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """gates [N, E] -> the one-hot masks [N, E] of each token's first and
    second choice, in the gates' dtype; ties in the argmax take the first
    expert."""
    e = gates.shape[1]
    mask1 = F.one_hot(torch.argmax(gates, dim=-1), e).to(gates.dtype)
    gates_wo1 = gates * (1.0 - mask1)
    mask2 = F.one_hot(torch.argmax(gates_wo1, dim=-1), e).to(gates.dtype)
    return mask1, mask2


def _dispatch_combine(gates, mask1, mask2, capacity: int, before1, before2,
                      first_total) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch [N, E, C] of 0/1, combine [N, E, C]) of a run of tokens
    whose experts already queued ``before1`` first and ``before2`` second
    choices ([1, E]) from earlier tokens, ``first_total`` first choices in
    all ([1, E]). A token's queue position within its expert is a
    cumulative sum in the gates' dtype (exact below 2^24 tokens in f32),
    second choices queued after every first choice."""
    pos1 = (torch.cumsum(mask1, dim=0) + before1) * mask1 - mask1
    pos2 = (torch.cumsum(mask2, dim=0) + before2 + first_total) \
        * mask2 - mask2
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)

    # renormalized top-2 weights of the kept tokens
    w1 = torch.sum(gates * keep1, dim=-1)
    w2 = torch.sum(gates * keep2, dim=-1)
    denom = torch.clamp(w1 + w2, min=1e-9)
    w1, w2 = w1 / denom, w2 / denom

    cap_iota = torch.arange(capacity, device=gates.device)
    d1 = keep1[..., None] * (pos1[..., None] == cap_iota)
    d2 = keep2[..., None] * (pos2[..., None] == cap_iota)
    dispatch = d1 + d2
    combine = d1 * w1[:, None, None] + d2 * w2[:, None, None]
    return dispatch, combine


def _top2_routing(gates: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates [N, E] -> (dispatch [N, E, C] of 0/1, combine [N, E, C], the
    top-1 mask [N, E]) of the whole batch."""
    mask1, mask2 = _top2_masks(gates)
    zero = torch.zeros((1, gates.shape[1]), dtype=gates.dtype,
                       device=gates.device)
    dispatch, combine = _dispatch_combine(
        gates, mask1, mask2, capacity, zero, zero,
        mask1.sum(dim=0, keepdim=True))
    return dispatch, combine, mask1


def moe_forward(cfg: MoEConfig, params: Dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], the load-balancing loss, a scalar:
    E * sum over experts of (fraction of tokens routed there first) x
    (mean gate)). The capacity is ``max(1, int(cf * N * 2 / E))``."""
    b, s, d = x.shape
    n = b * s
    dtype = cfg.dtype or x.dtype
    tokens = x.reshape(n, d)

    logits = tokens.float() @ params["gate"]["kernel"]
    gates = torch.softmax(logits, dim=-1)
    capacity = max(1, int(cfg.capacity_factor * n * 2 / cfg.num_experts))
    dispatch, combine, mask1 = _top2_routing(gates, capacity)

    frac_routed = torch.mean(mask1, dim=0)
    mean_gate = torch.mean(gates, dim=0)
    aux = cfg.num_experts * torch.sum(frac_routed * mean_gate)

    up = params["experts"]["up"].to(dtype)
    down = params["experts"]["down"].to(dtype)
    dispatch = dispatch.to(dtype)
    combine = combine.to(dtype)
    tokens = tokens.to(dtype)

    expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, up),
               approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", h, down)
    out = torch.einsum("nec,ecd->nd", combine, expert_out)
    return out.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------- expert axis


class ExpertPlan:
    """Where each position of an in-group mesh sits for the expert-parallel
    block: its batch shard (``batch_index``: the row-major index of its
    coordinates on ``batch_axes``; shard ``b`` holds the ``b``-th run of
    the batch's tokens), its expert coordinate (``expert_index``: it holds
    experts ``[k E / ep, (k + 1) E / ep)``), its ``plane`` (the positions
    sharing its coordinates on the other axes, in batch order: one whole
    copy of the batch) and its ``row`` (the positions differing from it on
    the expert axis alone, in expert order)."""

    def __init__(self, mesh, batch_axes: Sequence[str] = (AXIS_DATA,
                                                          AXIS_EXPERT)) -> None:
        from torchft_tpu_torch.parallel.sharding import _device

        shape, names = mesh.shape, mesh.axis_names
        self.devices = [_device(d) for d in mesh.devices.flat]
        self.ep = shape.get(AXIS_EXPERT, 1)
        self.batch_shards = int(np.prod([shape.get(a, 1)
                                         for a in batch_axes]))
        coords = [dict(zip(names, map(int, np.unravel_index(
            p, mesh.devices.shape)))) for p in range(mesh.size)]
        self.batch_index: List[int] = []
        for c in coords:
            b = 0
            for a in batch_axes:
                b = b * shape.get(a, 1) + c.get(a, 0)
            self.batch_index.append(b)
        self.expert_index = [c.get(AXIS_EXPERT, 0) for c in coords]
        planes: Dict[tuple, List[int]] = {}
        rows: Dict[tuple, List[int]] = {}
        for p, c in enumerate(coords):
            planes.setdefault(tuple(c[a] for a in names
                                    if a not in batch_axes), []).append(p)
            rows.setdefault(tuple(c[a] for a in names if a != AXIS_EXPERT),
                            []).append(p)
        self.planes = [sorted(ps, key=self.batch_index.__getitem__)
                       for ps in planes.values()]
        self.row: List[List[int]] = [[] for _ in coords]
        for ps in rows.values():
            ps = sorted(ps, key=self.expert_index.__getitem__)
            for p in ps:
                self.row[p] = ps


class _ExpertExchange(torch.autograd.Function):
    """Dispatch's all-to-all over the expert axis: each position's own
    experts' ``[E / ep, C, D]`` inputs, the sum over its row (in expert
    order) of those experts' slots of every row member's partial ``[E, C,
    D]``. A slot holds one token at most, so the sum is exact. The
    backward hands each partial its row's gradients, concatenated in expert
    order."""

    @staticmethod
    def forward(ctx, plan: ExpertPlan, *partials):
        ctx.plan = plan
        ctx.devices = [t.device for t in partials]
        eb = partials[0].shape[0] // plan.ep
        outs = []
        for p, row in enumerate(plan.row):
            lo = plan.expert_index[p] * eb
            acc = None
            for q in row:
                part = partials[q].narrow(0, lo, eb).to(ctx.devices[p])
                acc = part if acc is None else acc + part
            outs.append(acc.clone() if len(row) == 1 else acc)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        out = []
        for q, dev in enumerate(ctx.devices):
            parts = [grads[p].to(dev) for p in plan.row[q]]
            out.append(torch.cat(parts, 0) if len(parts) > 1
                       else parts[0].contiguous())
        return (None, *out)


class _ExpertGather(torch.autograd.Function):
    """Combine's all-gather over the expert axis: every expert's ``[E, C,
    D]`` outputs on each position, its row's ``[E / ep, C, D]`` outputs
    concatenated in expert order. The backward sums, in row order, the
    gradients of each position's experts' slots from its row."""

    @staticmethod
    def forward(ctx, plan: ExpertPlan, *outs):
        ctx.plan = plan
        ctx.devices = [t.device for t in outs]
        ctx.block = outs[0].shape[0]
        res = []
        for p, row in enumerate(plan.row):
            parts = [outs[q].to(ctx.devices[p]) for q in row]
            res.append(torch.cat(parts, 0) if len(parts) > 1
                       else parts[0].clone())
        return tuple(res)

    @staticmethod
    def backward(ctx, *grads):
        plan, eb = ctx.plan, ctx.block
        out = []
        for q, dev in enumerate(ctx.devices):
            lo = plan.expert_index[q] * eb
            acc = None
            for p in plan.row[q]:
                if grads[p] is None:
                    continue
                g = grads[p].narrow(0, lo, eb).to(dev)
                acc = g if acc is None else acc + g
            out.append(acc.contiguous() if acc is not None else None)
        return (None, *out)


def sharded_moe_forward(cfg: MoEConfig, plan: ExpertPlan,
                        gates: Sequence[torch.Tensor],
                        ups: Sequence[torch.Tensor],
                        downs: Sequence[torch.Tensor],
                        xs: Sequence[torch.Tensor]
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The MoE block over the positions of ``plan``, in lock-step: per
    position its tokens ``xs[p]`` ``[n, D]`` (its batch shard; each plane's
    positions hold the whole batch in batch order), the router ``gates[p]``
    ``[D, E]`` and its experts' ``ups[p]`` ``[E / ep, D, F]`` and
    ``downs[p]`` ``[E / ep, F, D]``. Returns each position's ``[n, D]``
    output in ``xs``' dtype and the load-balancing loss (f32, on position
    0's device), as :func:`moe_forward` computes them on the whole batch:
    the same capacity, the same tokens kept, dispatch exact, combine and
    the loss up to the order of their sums."""
    e = cfg.num_experts
    n_total = sum(xs[p].shape[0] for p in plan.planes[0])
    capacity = max(1, int(cfg.capacity_factor * n_total * 2 / e))
    dtype = cfg.dtype or xs[0].dtype

    probs, masks = [], []
    for x, w in zip(xs, gates):
        g = torch.softmax(x.float() @ w, dim=-1)
        probs.append(g)
        masks.append(_top2_masks(g))
    # each shard's tokens queue behind the earlier shards' (their counts
    # are exact integers in f32), second choices behind every first choice
    dispatch: List[Optional[torch.Tensor]] = [None] * len(xs)
    combine: List[Optional[torch.Tensor]] = [None] * len(xs)
    for plane in plan.planes:
        counts1 = [masks[p][0].sum(dim=0, keepdim=True) for p in plane]
        counts2 = [masks[p][1].sum(dim=0, keepdim=True) for p in plane]
        first_total = counts1[0]
        for c in counts1[1:]:
            first_total = first_total + c.to(first_total.device)
        before1 = torch.zeros_like(counts1[0])
        before2 = torch.zeros_like(counts1[0])
        for i, p in enumerate(plane):
            dev = xs[p].device
            dispatch[p], combine[p] = _dispatch_combine(
                probs[p], *masks[p], capacity, before1.to(dev),
                before2.to(dev), first_total.to(dev))
            before1 = before1 + counts1[i].to(before1.device)
            before2 = before2 + counts2[i].to(before2.device)

    # the load-balancing loss from global sums over the first plane
    dev0 = xs[0].device
    plane = plan.planes[0]
    routed = gate_sum = None
    for p in plane:
        r = masks[p][0].sum(dim=0).to(dev0)
        s = probs[p].sum(dim=0).to(dev0)
        routed = r if routed is None else routed + r
        gate_sum = s if gate_sum is None else gate_sum + s
    aux = e * torch.sum((routed / n_total) * (gate_sum / n_total))

    partials = [torch.einsum("nec,nd->ecd", d.to(dtype), x.to(dtype))
                for d, x in zip(dispatch, xs)]
    expert_in = _ExpertExchange.apply(plan, *partials)
    outs = []
    for x_in, up, down in zip(expert_in, ups, downs):
        h = F.gelu(torch.einsum("ecd,edf->ecf", x_in, up.to(dtype)),
                   approximate="tanh")
        outs.append(torch.einsum("ecf,efd->ecd", h, down.to(dtype)))
    expert_out = _ExpertGather.apply(plan, *outs)
    ys = [torch.einsum("nec,ecd->nd", c.to(dtype), o).to(x.dtype)
          for c, o, x in zip(combine, expert_out, xs)]
    return ys, aux


def moe_forward_sharded(cfg: MoEConfig, params: Dict, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_forward` on ``params`` sharded by ``moe_rules()`` (a tree
    of ``ShardedTensor`` s, ``shard_pytree(params, mesh, moe_rules(),
    fsdp_axis=None)``): ``x`` ``[B, S, D]``'s tokens split in order over
    the mesh's ``data`` x ``expert`` shards, each on its position's device,
    through :func:`sharded_moe_forward`; returns the whole ``y`` (on
    ``x``'s device) and the loss."""
    up, down = params["experts"]["up"], params["experts"]["down"]
    gate = params["gate"]["kernel"]
    mesh = up.sharding.mesh
    plan = ExpertPlan(mesh)
    b, s, d = x.shape
    n = b * s
    if n % plan.batch_shards:
        raise ValueError(f"{n} tokens do not split over "
                         f"{plan.batch_shards} data x expert shards")
    if up.sharding.spec[:1] != (("expert",) if plan.ep > 1 else (None,)):
        raise ValueError(f"experts in {up.sharding.spec}, not split on "
                         f"their first dimension over the expert axis")
    chunk = n // plan.batch_shards
    tokens = x.reshape(n, d)
    xs = [tokens[i * chunk:(i + 1) * chunk].to(plan.devices[p])
          for p, i in enumerate(plan.batch_index)]
    pos = range(mesh.size)
    ys, aux = sharded_moe_forward(
        cfg, plan, [gate.piece_at(p) for p in pos],
        [up.piece_at(p) for p in pos], [down.piece_at(p) for p in pos], xs)
    y = torch.cat([ys[p].to(x.device) for p in plan.planes[0]])
    return y.reshape(b, s, d), aux
