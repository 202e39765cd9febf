"""Attention ops: the flash kernels on the GPU, the plain path on the CPU.

Twin of ``torchft_tpu/ops/attention.py``. ``causal_attention`` sends CUDA
tensors to the hand-written flash kernels (``ops/flash.py``) and CPU tensors
to ``reference_attention``. There is no probe and no fallback: a CUDA input
the kernels do not take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["causal_attention", "reference_attention"]


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """``[B, S, H, D]`` einsum attention: f32 scores and softmax, masked
    with -inf, P cast to ``v``'s dtype before P V."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        seq = q.shape[1]
        mask = torch.tril(torch.ones(seq, seq, dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def causal_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Causal ``[B, S, H, D]`` attention: the flash kernels for CUDA
    tensors, :func:`reference_attention` for CPU tensors."""
    if q.is_cuda:
        from torchft_tpu_torch.ops.flash import flash_attention

        return flash_attention(q, k, v, causal=True, scale=scale)
    return reference_attention(q, k, v, causal=True, scale=scale)
