"""Memory-efficient cross entropy: online logsumexp over vocab chunks.

Twin of ``hidden_cross_entropy`` in ``torchft_tpu/ops/xent.py``. At the
flagship shapes (small d_model, 32k vocab) the [N, V] logits are the largest
tensor of the step; ``chunked_lse_and_target`` never materializes them. Its
forward runs the online-softmax recurrence over ``num_chunks`` vocab chunks
(running max m, running sum s rescaled by exp(m_old - m_new), and the target
logit gathered from whichever chunk holds it); its backward recomputes each
chunk's logits and accumulates

    dlogits_c = exp(logits_c - lse) * g_lse + onehot_c * g_tl
    dx       += dlogits_c w_c^T
    dw_c      = x^T dlogits_c

so one [N, V/C] tile is live at a time. The products are plain f32 matrix
products (this is not a Pallas kernel in the reference either).
Out-of-range targets clamp, as the dense gather does.

``make_vocab_parallel_cross_entropy`` is the loss of a vocab-sharded lm
head (``tp_rules_gpt``'s ``P(..., "tensor")``): each shard of the axis runs
the chunked recurrence on its own ``[D, V/n]`` piece, its targets masked to
the shard, and the shards combine through the max of their detached lse,
``m + log(sum_i exp(lse_i - m))``, and the sum of their target logits. The
reference combines them with ``psum`` under ``shard_map``; here the shards
run in lock-step in one process and the combination moves each shard's
``[N]`` statistics to the first shard's device, adding them in shard order.
No ``[N, V]`` or ``[N, V/n]`` gather ever forms.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["chunked_cross_entropy", "chunked_lse_and_target",
           "hidden_cross_entropy", "make_vocab_parallel_cross_entropy",
           "vocab_parallel_nll"]


def _check_chunks(v: int, num_chunks: int) -> int:
    if v % num_chunks:
        raise ValueError(
            f"vocab size {v} is not divisible by xent chunk count "
            f"{num_chunks} (set xent_chunks to a divisor of the vocab)"
        )
    return v // num_chunks


class _ChunkedLseAndTarget(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, num_chunks, mask):
        n = x.shape[0]
        v = w.shape[1]
        vc = _check_chunks(v, num_chunks)
        t = targets.clamp(0, v - 1)
        m = torch.full((n,), float("-inf"), dtype=torch.float32,
                       device=x.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        tl = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for ci in range(num_chunks):
            logits = (x @ w[:, ci * vc:(ci + 1) * vc]).float()   # [N, Vc]
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            local = t - ci * vc
            in_chunk = (local >= 0) & (local < vc)
            picked = logits.gather(1, local.clamp(0, vc - 1)[:, None])[:, 0]
            tl = torch.where(in_chunk, picked, tl)
            m = m_new
        lse = m + torch.log(s)
        if mask is not None:
            tl = torch.where(mask, tl, torch.zeros_like(tl))
        ctx.save_for_backward(x, w, t, lse, mask)
        ctx.num_chunks = num_chunks
        return lse, tl

    @staticmethod
    def backward(ctx, g_lse, g_tl):
        x, w, t, lse, mask = ctx.saved_tensors
        num_chunks = ctx.num_chunks
        vc = w.shape[1] // num_chunks
        if g_lse is None:
            g_lse = torch.zeros_like(lse)
        if g_tl is None:
            g_tl = torch.zeros_like(lse)
        if mask is not None:
            g_tl = torch.where(mask, g_tl, torch.zeros_like(g_tl))
        xf = x.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        for ci in range(num_chunks):
            wc = w[:, ci * vc:(ci + 1) * vc]
            logits = (x @ wc).float()
            p = torch.exp(logits - lse[:, None])
            local = t - ci * vc
            in_chunk = (local >= 0) & (local < vc)
            onehot = torch.zeros_like(p)
            onehot.scatter_(1, local.clamp(0, vc - 1)[:, None],
                            in_chunk[:, None].float())
            dlogits = p * g_lse[:, None] + onehot * g_tl[:, None]
            dx += dlogits @ wc.float().T
            dw[:, ci * vc:(ci + 1) * vc] = xf.T @ dlogits
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def chunked_lse_and_target(x, w, targets, num_chunks: int = 8, *,
                           mask=None):
    """``(lse [N], target_logit [N])`` of logits = x @ w without forming
    [N, V]. x: [N, D], w: [D, V] with V % num_chunks == 0, targets [N]
    (clamped to [0, V - 1]). ``mask`` (the reference's fourth argument,
    a keyword here): a bool [N]; rows where it is False report a target
    logit of 0 and get no one-hot gradient (the vocab-parallel loss's
    targets outside a shard). None is every row, bitwise as an all-True
    mask."""
    return _ChunkedLseAndTarget.apply(x, w, targets, num_chunks, mask)


def chunked_cross_entropy(x, w, targets, num_chunks: int = 8):
    """Mean NLL of softmax(x @ w) rows against integer targets."""
    lse, tl = chunked_lse_and_target(x, w, targets, num_chunks)
    return (lse - tl).mean()


def hidden_cross_entropy(h, w, targets, num_chunks: int):
    """Mean CE of [B, S, D] hidden states against [B, S] targets through
    the vocab projection ``w`` [D, V], chunked, in f32."""
    d = h.shape[-1]
    return chunked_cross_entropy(h.float().reshape(-1, d), w.float(),
                                 targets.reshape(-1), num_chunks)


def vocab_parallel_nll(hs, ws, targets, num_chunks: int = 1):
    """Per-row NLL ``[N]`` of a vocab-sharded lm head, on ``hs[0]``'s
    device: shard ``i`` holds ``ws[i]`` ``[D, V/n]`` (vocab rows ``i V/n``
    up to ``(i + 1) V/n``) and the hidden states ``hs[i]`` ``[N, D]`` on its
    device. Targets clip to [0, V - 1] as the dense path clips them."""
    n = len(ws)
    vloc = ws[0].shape[1]
    root = hs[0].device
    t = targets.clamp(0, vloc * n - 1)
    lses, tls = [], []
    for i, (h, w) in enumerate(zip(hs, ws)):
        t_loc = t.to(w.device) - i * vloc
        mask = (t_loc >= 0) & (t_loc < vloc)
        lse, tl = chunked_lse_and_target(h.float(), w.float(), t_loc,
                                         num_chunks, mask=mask)
        lses.append(lse.to(root))
        tls.append(tl.to(root))
    # the stabilizer: max over shards of a gradient-stopped copy (max
    # subtraction is gradient-neutral)
    m = lses[0].detach()
    for lse in lses[1:]:
        m = torch.maximum(m, lse.detach())
    s = torch.exp(lses[0] - m)
    tl = tls[0]
    for lse, tli in zip(lses[1:], tls[1:]):
        s = s + torch.exp(lse - m)
        tl = tl + tli
    return m + torch.log(s) - tl


def make_vocab_parallel_cross_entropy(mesh, axis_name: str = "tensor",
                                      num_chunks: int = 1):
    """Mean CE of a vocab-sharded lm head over ``axis_name`` of ``mesh``
    (a ``parallel.mesh.Mesh``): returns ``loss(h, w, targets)`` with h
    ``[N, D]`` (copied to each shard's device), targets ``[N]`` and w a
    ``parallel.sharding.ShardedTensor`` ``[D, V]`` of spec ``(None,
    axis_name)``. Gradients reach each piece on its own device, in its own
    shape: the head stays sharded. The result is on the first shard's
    device."""
    from torchft_tpu_torch.parallel.sharding import PartitionSpec

    devices = [torch.device(d) for d in mesh.axis_devices(axis_name)]
    grid = mesh.devices.shape
    axis = mesh.axis_names.index(axis_name)
    positions = []
    for i in range(mesh.shape[axis_name]):
        coord = [0] * len(grid)
        coord[axis] = i
        positions.append(int(np.ravel_multi_index(coord, grid)))

    def loss(h, w, targets):
        if w.sharding.spec != PartitionSpec(None, axis_name):
            raise ValueError(f"the lm head must be split on its vocab "
                             f"dimension over {axis_name!r} alone, not "
                             f"{w.sharding.spec}")
        ws = [w.piece_at(p) for p in positions]
        return vocab_parallel_nll([h.to(d) for d in devices], ws, targets,
                                  num_chunks).mean()

    return loss
