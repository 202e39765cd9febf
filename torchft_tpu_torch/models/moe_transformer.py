"""Mixture-of-Experts decoder-only transformer (GShard style).

Twin of ``torchft_tpu/models/moe_transformer.py`` as an ``nn.Module`` on
the dense GPT's blocks (``models/transformer.py``): every ``moe_every``-th
layer (``i % moe_every == moe_every - 1``) replaces its dense MLP with the
capacity-based top-2 MoE block of ``parallel/moe.py``. Parameters carry the
JAX pytree's names (``layers_1.moe.gate.kernel``,
``layers_1.moe.experts.up``), so ``from_jax_params`` maps a reference
model's parameters onto this one. The loss is the next-token cross entropy
(ops/xent.py's chunked scan when ``xent_chunks`` > 0) plus
``aux_loss_weight`` times the summed load-balancing losses. With ``remat``
each block's forward runs again in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
Attention goes through ``ops.attention.causal_attention``: the flash
kernels on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from torchft_tpu_torch.models.transformer import (
    GPT,
    Block,
    TransformerConfig,
    _Attn,
    _layer_norm,
    _Param,
    attn_sublayer,
)
from torchft_tpu_torch.parallel.moe import MoEConfig, moe_forward

__all__ = ["MOE_CONFIGS", "MoEBlock", "MoETransformer",
           "MoETransformerConfig"]


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig:
    vocab_size: int = 32768
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 1024
    num_experts: int = 8
    capacity_factor: float = 1.25
    moe_every: int = 2          # layer i is MoE iff i % moe_every == 1
    aux_loss_weight: float = 1e-2
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    xent_chunks: int = 0

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    def is_moe_layer(self, i: int) -> bool:
        return i % self.moe_every == self.moe_every - 1

    def dense_cfg(self) -> TransformerConfig:
        """The dense skeleton this family shares its blocks with."""
        return TransformerConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_layers, n_heads=self.n_heads, d_ff=self.d_ff,
            max_seq_len=self.max_seq_len, dtype=self.dtype,
            param_dtype=self.param_dtype, remat=self.remat,
            xent_chunks=self.xent_chunks,
        )

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         num_experts=self.num_experts,
                         capacity_factor=self.capacity_factor,
                         dtype=self.dtype)


MOE_CONFIGS: Dict[str, MoETransformerConfig] = {
    "moe-tiny": MoETransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=256,
        max_seq_len=128, num_experts=4, remat=False,
    ),
    # the 125m backbone with 8 experts on alternating layers
    "moe-8x125m": MoETransformerConfig(
        vocab_size=32768, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
        max_seq_len=1024, num_experts=8, xent_chunks=8,
    ),
}


class _MoE(nn.Module):
    def __init__(self, cfg: MoEConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.gate = _Param(kernel=(cfg.d_model, cfg.num_experts))
        self.experts = _Param(up=(cfg.num_experts, cfg.d_model, cfg.d_ff),
                              down=(cfg.num_experts, cfg.d_ff, cfg.d_model))

    def forward(self, x):
        return moe_forward(self.cfg, {
            "gate": {"kernel": self.gate.kernel},
            "experts": {"up": self.experts.up, "down": self.experts.down},
        }, x)


class MoEBlock(nn.Module):
    """The dense block's attention sublayer, then the MoE feed-forward:
    ``x -> (x, aux)``. Tokens over capacity get 0 from the MoE, so the
    residual passes them through."""

    def __init__(self, cfg: MoETransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg.dense_cfg()
        d = cfg.d_model
        self.ln_1 = _Param(scale=(d,), bias=(d,))
        self.attn = _Attn(d)
        self.ln_2 = _Param(scale=(d,), bias=(d,))
        self.moe = _MoE(cfg.moe_cfg())

    def forward(self, x):
        x = attn_sublayer(self, x)
        y, aux = self.moe(_layer_norm(x, self.ln_2.scale, self.ln_2.bias))
        return x + y, aux


class MoETransformer(GPT):
    """tokens [B, S] -> final-norm hidden states / loss, with MoE blocks on
    the layers ``cfg.is_moe_layer`` picks. Built like :class:`GPT`: on
    ``device`` (CUDA by default), f32 parameters drawn from a generator
    seeded with ``seed`` (the experts scaled by 1/sqrt of their fan-in, as
    the reference)."""

    def __init__(self, cfg: MoETransformerConfig,
                 device: "Optional[str | torch.device]" = None,
                 seed: int = 0) -> None:
        self.moe_config = cfg
        super().__init__(cfg, device=device, seed=seed)

    def _block(self, i: int) -> nn.Module:
        if self.moe_config.is_moe_layer(i):
            return MoEBlock(self.moe_config)
        return Block(self.moe_config.dense_cfg())

    def forward_hidden_aux(self, tokens):
        """(final-norm hidden states [B, S, D], the summed aux loss)."""
        dt = self.cfg.dtype
        s = tokens.shape[1]
        x = self.wte.embedding.to(dt)[tokens]
        x = x + self.wpe.embedding.to(dt)[:s][None, :, :]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(self.blocks()):
            if self.cfg.remat and torch.is_grad_enabled():
                out = torch.utils.checkpoint.checkpoint(block, x,
                                                        use_reentrant=False)
            else:
                out = block(x)
            if self.moe_config.is_moe_layer(i):
                x, aux = out
                aux_total = aux_total + aux.float()
            else:
                x = out
        return _layer_norm(x, self.ln_f.scale, self.ln_f.bias), aux_total

    def forward_hidden(self, tokens):
        return self.forward_hidden_aux(tokens)[0]

    def loss(self, tokens, targets):
        """Mean next-token cross entropy + aux_loss_weight x the summed
        load-balancing losses."""
        h, aux = self.forward_hidden_aux(tokens)
        return (self.cross_entropy(h, targets)
                + self.moe_config.aux_loss_weight * aux)
