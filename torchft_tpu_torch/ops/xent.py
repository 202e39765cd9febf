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
"""

from __future__ import annotations

import torch

__all__ = ["chunked_cross_entropy", "chunked_lse_and_target",
           "hidden_cross_entropy"]


def _check_chunks(v: int, num_chunks: int) -> int:
    if v % num_chunks:
        raise ValueError(
            f"vocab size {v} is not divisible by xent chunk count "
            f"{num_chunks} (set xent_chunks to a divisor of the vocab)"
        )
    return v // num_chunks


class _ChunkedLseAndTarget(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, num_chunks):
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
        ctx.save_for_backward(x, w, t, lse)
        ctx.num_chunks = num_chunks
        return lse, tl

    @staticmethod
    def backward(ctx, g_lse, g_tl):
        x, w, t, lse = ctx.saved_tensors
        num_chunks = ctx.num_chunks
        vc = w.shape[1] // num_chunks
        if g_lse is None:
            g_lse = torch.zeros_like(lse)
        if g_tl is None:
            g_tl = torch.zeros_like(lse)
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
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def chunked_lse_and_target(x, w, targets, num_chunks: int = 8):
    """``(lse [N], target_logit [N])`` of logits = x @ w without forming
    [N, V]. x: [N, D], w: [D, V] with V % num_chunks == 0."""
    return _ChunkedLseAndTarget.apply(x, w, targets, num_chunks)


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
