"""Ring attention: sequence (context) parallelism over a mesh axis.

Twin of ``torchft_tpu/parallel/ring.py``. The sequence dimension of global
``[B, S, H, D]`` tensors is split into the axis's shards; each shard holds
a Q/K/V block, and the K/V blocks rotate one step around the ring (shard
``i`` -> ``i + 1``) per ring step while each shard accumulates exact
attention over the blocks passing through it. The reference runs one
shard per device under ``shard_map`` and rotates with ``lax.ppermute``;
here the shards run in lock-step in one process, and a rotation moves
each block to its successor's device (``Mesh.axis_devices``). On a virtual
mesh (one device repeated, ``ft_mesh({"seq": 4}, devices=["cuda"] * 4)``)
a rotation moves no bytes: the schedule, the block calls and the numerics
are the ring's, and nothing crosses a link.

Two block implementations, as in the reference:

- ``"einsum"``: the streaming online softmax in f32 with the
  fully-masked-row guards, in plain torch ops under autograd (the
  reference computes it in XLA, not in Pallas). Every (q, kv) pair runs,
  masked.
- ``"flash"``: each pair runs ``ops.flash.flash_attention_with_lse`` (the
  flash forward kernel on the card, its plain version on the CPU) and the
  per-pair (out, lse) streams merge by the logaddexp rule. Causality is
  handled at block granularity (:func:`ring_schedule`): a kv block in the
  future of the q shard makes no call at all, the diagonal pair runs the
  causal kernel and past pairs the unmasked one. Its backward is the
  ring-structured FlashAttention-2 backward: with the GLOBAL lse and
  Delta = rowsum(dO * O), every pair's contribution is independent, so
  ``flash_block_attention_bwd`` runs pair by pair on the same schedule,
  the dK/dV accumulators rotating with their K/V blocks and dQ
  accumulating in place.

Under ``torch.utils.checkpoint`` the forward runs again in the backward,
so a training pass makes twice the forward calls (:func:`ring_launches`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from torchft_tpu_torch.ops.flash import (
    flash_attention_with_lse,
    flash_block_attention_bwd,
)

__all__ = ["make_ring_attention", "ring_attention", "ring_launches",
           "ring_schedule"]


def _pair_kind(idx: int, src: int, causal: bool) -> str:
    """How q shard ``idx`` attends to kv block ``src``: "causal" (the
    diagonal pair of a causal ring), "full" (a past pair, or any pair
    without causality) or "skip" (a future pair: no call)."""
    if not causal:
        return "full"
    if src > idx:
        return "skip"
    return "causal" if src == idx else "full"


def ring_schedule(n: int, causal: bool) -> List[Tuple[int, int, int, str]]:
    """The flash ring's pairs in the order it runs them: ``(t, idx, src,
    kind)`` for ring step ``t`` and q shard ``idx``, which holds kv block
    ``src = (idx - t) % n`` then (``kind`` as :func:`_pair_kind`)."""
    return [(t, idx, (idx - t) % n, _pair_kind(idx, (idx - t) % n, causal))
            for t in range(n) for idx in range(n)]


def ring_launches(n: int, causal: bool = True,
                  remat: bool = False) -> Dict[str, int]:
    """Flash kernel calls of one ring attention in one forward/backward
    pass: one forward and one of each backward kernel per pair that runs,
    the forward twice under activation checkpointing. A causal ring of
    ``n`` shards runs n(n+1)/2 pairs, n of them causal."""
    pairs = sum(1 for *_, kind in ring_schedule(n, causal) if kind != "skip")
    return {"flash_fwd": pairs * (2 if remat else 1),
            "flash_bwd_dq": pairs, "flash_bwd_dkv": pairs}


def _rotate(held: List[list], devices: Sequence[torch.device]) -> List[list]:
    """One ring step: what shard ``i`` holds moves to shard ``i + 1``'s
    device (the reference's ``ppermute(i -> i + 1)``)."""
    n = len(held)
    return [[x.to(devices[i]) for x in held[(i - 1) % n]] for i in range(n)]


# ------------------------------------------------------------ einsum ring


def _local_attention_step(q, k, v, o, m, l, q_offset: int, k_offset: int,
                          scale: float, causal: bool):
    """One streaming-softmax accumulation of a (q-block, kv-block) pair:
    q [B, Sq, H, D], k/v [B, Sk, H, D], the numerator o [B, Sq, H, D] and
    the running max m and denominator l [B, H, Sq]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg_inf = torch.tensor(float("-inf"), dtype=s.dtype, device=s.device)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=s.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=s.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, neg_inf)
    m_new = torch.maximum(m, s.amax(-1))
    # fully masked rows (m_new == -inf): exp(-inf - -inf) would be nan
    m_safe = torch.where(torch.isneginf(m_new), zero, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), zero, p)
    alpha = torch.exp(torch.where(torch.isneginf(m), zero, m) - m_safe)
    alpha = torch.where(torch.isneginf(m), zero, alpha)  # no history yet
    l_new = alpha * l + p.sum(-1)
    o_new = (o * alpha.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v))
    return o_new, m_new, l_new


def _einsum_ring(qs, ks, vs, devices, causal: bool, scale: float):
    n = len(qs)
    b, s_local, h, _ = qs[0].shape
    state = []
    for q in qs:
        rows = (b, h, s_local)
        state.append((torch.zeros(q.shape, dtype=torch.float32,
                                  device=q.device),
                      torch.full(rows, float("-inf"), device=q.device),
                      torch.zeros(rows, device=q.device)))
    qf = [q.float() for q in qs]
    held = [[k, v] for k, v in zip(ks, vs)]
    for t in range(n):
        for idx in range(n):
            src = (idx - t) % n
            k_t, v_t = held[idx]
            state[idx] = _local_attention_step(
                qf[idx], k_t.float(), v_t.float(), *state[idx],
                q_offset=idx * s_local, k_offset=src * s_local,
                scale=scale, causal=causal)
        if t < n - 1:
            held = _rotate(held, devices)
    outs = []
    for q, (o, _, l) in zip(qs, state):
        l = torch.where(l == 0.0, torch.ones_like(l), l)  # masked -> 0
        outs.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return outs


# ------------------------------------------------------------- flash ring


@dataclasses.dataclass(frozen=True)
class _RingArgs:
    devices: Tuple[torch.device, ...]
    causal: bool
    scale: float
    block_q: int
    block_k: int

    @property
    def n(self) -> int:
        return len(self.devices)


def _merge(o_acc, lse_acc, o_t, lse_t):
    """The exact two-stream merge (flash-decoding rule). A row dead in
    both streams keeps lse -inf and gets weight 0 from each: the weights
    are guarded, not the lse."""
    lse_new = torch.logaddexp(lse_acc, lse_t)
    dead = torch.isneginf(lse_new)
    zero = torch.zeros((), dtype=lse_new.dtype, device=lse_new.device)
    w_acc = torch.where(dead, zero, torch.exp(lse_acc - lse_new))
    w_t = torch.where(dead, zero, torch.exp(lse_t - lse_new))
    o_new = (o_acc * w_acc.transpose(1, 2)[..., None]
             + o_t.float() * w_t.transpose(1, 2)[..., None])
    return o_new, lse_new


def _ring_flash_fwd(qs, ks, vs, args: _RingArgs):
    """(outs, lses): each shard's output in q's dtype and its global lse
    [B, H, S_local] f32."""
    n = args.n
    o_acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
             for q in qs]
    lse_acc = [torch.full((q.shape[0], q.shape[2], q.shape[1]),
                          float("-inf"), device=q.device) for q in qs]
    held = [[k, v] for k, v in zip(ks, vs)]
    for t in range(n):
        for idx in range(n):
            kind = _pair_kind(idx, (idx - t) % n, args.causal)
            if kind == "skip":  # a future block: no call, nothing to merge
                continue
            k_t, v_t = held[idx]
            o_t, lse_t = flash_attention_with_lse(
                qs[idx], k_t, v_t, causal=kind == "causal", scale=args.scale,
                block_q=args.block_q, block_k=args.block_k)
            o_acc[idx], lse_acc[idx] = _merge(o_acc[idx], lse_acc[idx],
                                              o_t, lse_t)
        if t < n - 1:
            held = _rotate(held, args.devices)
    return [o.to(q.dtype) for o, q in zip(o_acc, qs)], lse_acc


def _ring_flash_bwd(qs, ks, vs, outs, lses, gs, args: _RingArgs):
    """(dqs, dks, dvs): the ring-structured FlashAttention-2 backward."""
    n = args.n
    # Delta is local: each shard's out and its cotangent. [B, H, S_local]
    deltas = [(g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
              for g, o in zip(gs, outs)]
    dq_acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
              for q in qs]
    held = [[k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
             torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
            for k, v in zip(ks, vs)]
    for t in range(n):
        for idx in range(n):
            kind = _pair_kind(idx, (idx - t) % n, args.causal)
            if kind == "skip":
                continue
            k_t, v_t, dk_t, dv_t = held[idx]
            dq_p, dk_p, dv_p = flash_block_attention_bwd(
                qs[idx], k_t, v_t, gs[idx], lses[idx], deltas[idx],
                causal=kind == "causal", scale=args.scale,
                block_q=args.block_q, block_k=args.block_k)
            dq_acc[idx] += dq_p.float()
            dk_t += dk_p.float()
            dv_t += dv_p.float()
        # every step rotates, the last included: after n hops each dK/dV
        # accumulator is back on its own block's shard
        held = _rotate(held, args.devices)
    return ([dq.to(q.dtype) for dq, q in zip(dq_acc, qs)],
            [h[2].to(k.dtype) for h, k in zip(held, ks)],
            [h[3].to(v.dtype) for h, v in zip(held, vs)])


class _RingFlash(torch.autograd.Function):
    """Inputs: the args, then the n q shards, n k shards and n v shards
    (each contiguous, on its shard's device); outputs: the n out shards."""

    @staticmethod
    def forward(ctx, args: _RingArgs, *shards):
        n = args.n
        qs, ks, vs = shards[:n], shards[n:2 * n], shards[2 * n:]
        outs, lses = _ring_flash_fwd(qs, ks, vs, args)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.args = args
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        args = ctx.args
        n = args.n
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        # the cotangent arrives in the output's dtype, maybe strided
        gs = [torch.zeros_like(o) if g is None
              else g.to(o.dtype).contiguous() for g, o in zip(gs, outs)]
        dqs, dks, dvs = _ring_flash_bwd(qs, ks, vs, outs, lses, gs, args)
        return (None, *dqs, *dks, *dvs)


def make_ring_attention(mesh, axis_name: str = "seq", causal: bool = True,
                        scale: Optional[float] = None,
                        block_impl: str = "einsum",
                        block_q: int = 128, block_k: int = 128):
    """An attention fn over GLOBAL ``[B, S, H, D]`` q, k, v (S divisible by
    the axis's size) returning the global output on q's device: S is split
    into the shards of ``axis_name`` of ``mesh`` (a :class:`Mesh` or an
    ``FTMesh``), each shard made contiguous on its device, the ring runs
    them in lock-step, and the outputs are concatenated. Differentiable
    with either ``block_impl`` ("einsum" or "flash"; see the module
    docstring). ``block_q``/``block_k`` are the flash wrappers' block
    sizes, clamped to the shard's length."""
    if block_impl not in ("einsum", "flash"):
        raise ValueError(
            f"unknown block_impl {block_impl!r}; have 'einsum', 'flash'"
        )
    mesh = getattr(mesh, "mesh", mesh)  # an FTMesh's in-group mesh
    devices = tuple(mesh.axis_devices(axis_name))
    n = len(devices)

    def fn(q, k, v):
        b, s, h, d = q.shape
        if s % n:
            raise ValueError(f"seq len {s} does not split over the {n} "
                             f"shards of axis {axis_name!r}")
        sl = s // n
        eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)

        def split(x):
            return [x[:, i * sl:(i + 1) * sl].to(devices[i]).contiguous()
                    for i in range(n)]

        qs, ks, vs = split(q), split(k), split(v)
        if block_impl == "flash":
            args = _RingArgs(devices, causal, eff_scale, block_q, block_k)
            outs = _RingFlash.apply(args, *qs, *ks, *vs)
        else:
            outs = _einsum_ring(qs, ks, vs, devices, causal, eff_scale)
        return torch.cat([o.to(q.device) for o in outs], dim=1)

    return fn


def ring_attention(q, k, v, mesh, axis_name: str = "seq",
                   causal: bool = True, scale: Optional[float] = None,
                   block_impl: str = "einsum",
                   block_q: int = 128, block_k: int = 128):
    """One-shot convenience wrapper around :func:`make_ring_attention`."""
    return make_ring_attention(
        mesh, axis_name, causal, scale,
        block_impl=block_impl, block_q=block_q, block_k=block_k,
    )(q, k, v)
