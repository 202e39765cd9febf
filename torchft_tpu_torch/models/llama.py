"""Llama-family decoder: RMSNorm + RoPE + SwiGLU + grouped-query attention.

Twin of ``torchft_tpu/models/llama.py`` as an ``nn.Module``. The
parameters carry the JAX pytree's paths: ``tok_embed.embedding``,
``lm_head.kernel``, ``final_norm.scale`` and, for layer ``i`` (entry ``i``
of the reference's ``layers`` list), ``layers.i.attn_norm.scale``,
``layers.i.attn.{q,k,v,o}_proj.kernel``, ``layers.i.mlp_norm.scale`` and
``layers.i.mlp.{gate,up,down}_proj.kernel``, kernels ``[in, out]``; so
``from_jax_params`` maps a reference model's parameters onto this one, and
:func:`llama_param_tree` gives the reference's nested structure back (a
heal manifest over it lists the reference's leaves, paths and order).

Numerics mirror the reference: f32 parameters, bf16 activations; RMSNorm
in f32 with ``rsqrt``, cast back; RoPE angles in f32 from
``theta ** (-arange(half) / half)``, rotating the two halves of each head;
K/V heads repeated for GQA as ``jnp.repeat(axis=2)`` does
(``repeat_interleave``: head ``j`` serves query heads ``j*rep ..
j*rep+rep-1``); SwiGLU ``silu(gate) * up`` in the compute dtype; the logits
and the loss in f32, chunked over the vocab when ``xent_chunks`` > 0.
Attention is ``ops.attention.causal_attention`` (the flash kernels on the
card, their plain path on the CPU) unless the caller passes ``attn_fn``,
e.g. a ring over a sequence axis (``parallel/ring.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchft_tpu_torch.models.transformer import _Param
from torchft_tpu_torch.ops.attention import causal_attention
from torchft_tpu_torch.ops.xent import hidden_cross_entropy
from torchft_tpu_torch.utils.device import resolve_device

__all__ = ["LLAMA_CONFIGS", "Llama", "LlamaConfig", "llama_forward",
           "llama_forward_hidden", "llama_init_params", "llama_loss_fn",
           "llama_param_tree"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 4          # GQA: kv heads < query heads
    d_ff: int = 1408             # ~8/3 * d_model, SwiGLU sizing
    max_seq_len: int = 512
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    # > 0: the loss runs ops/xent.py's online logsumexp over this many
    # vocab chunks instead of materializing [B, S, V] logits
    xent_chunks: int = 0

    def __post_init__(self) -> None:
        # the reference's checks, raised as ValueError (an assert vanishes
        # under python -O)
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads "
                f"{self.n_kv_heads} (GQA repeat factor must be integral)")
        if (self.d_model // self.n_heads) % 2:
            raise ValueError(f"head_dim {self.d_model // self.n_heads} must "
                             "be even (RoPE rotates dimension pairs)")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


LLAMA_CONFIGS: Dict[str, LlamaConfig] = {
    "llama_tiny": LlamaConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=176, max_seq_len=128, remat=False,
    ),
    "llama_120m": LlamaConfig(
        vocab_size=32768, d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=4, d_ff=2048, max_seq_len=1024,
    ),
}


def _rms_norm(x, scale, eps: float):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _rope(x, theta: float):
    """Rotary embedding over [B, S, H, D] (D even): the two halves of each
    head rotate against each other, positions 0..S-1."""
    _, s, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = torch.arange(s, dtype=torch.float32,
                          device=x.device)[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]   # [1, S, 1, D/2]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def repeat_kv(x, rep: int):
    """GQA's head repeat, ``jnp.repeat(x, rep, axis=2)``: each K/V head
    ``rep`` times in a row (not the whole head axis tiled)."""
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


class _Module(nn.Module):
    """Named children, so state-dict keys spell the JAX paths."""

    def __init__(self, **children) -> None:
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.cfg = cfg
        d, kv_d = cfg.d_model, cfg.n_kv_heads * cfg.head_dim
        self.attn_norm = _Param(scale=(d,))
        self.attn = _Module(q_proj=_Param(kernel=(d, d)),
                            k_proj=_Param(kernel=(d, kv_d)),
                            v_proj=_Param(kernel=(d, kv_d)),
                            o_proj=_Param(kernel=(d, d)))
        self.mlp_norm = _Param(scale=(d,))
        self.mlp = _Module(gate_proj=_Param(kernel=(d, cfg.d_ff)),
                           up_proj=_Param(kernel=(d, cfg.d_ff)),
                           down_proj=_Param(kernel=(cfg.d_ff, d)))

    def forward(self, x, attn_fn: Optional[Callable] = None):
        cfg, dt = self.cfg, self.cfg.dtype
        b, s, _ = x.shape
        hd = cfg.head_dim
        attn, mlp = self.attn, self.mlp
        h = _rms_norm(x, self.attn_norm.scale, cfg.rms_eps)
        q = (h @ attn.q_proj.kernel.to(dt)).reshape(b, s, cfg.n_heads, hd)
        k = (h @ attn.k_proj.kernel.to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
        v = (h @ attn.v_proj.kernel.to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
        q = _rope(q, cfg.rope_theta)
        k = _rope(k, cfg.rope_theta)
        rep = cfg.n_heads // cfg.n_kv_heads
        k, v = repeat_kv(k, rep), repeat_kv(v, rep)
        fn = causal_attention if attn_fn is None else attn_fn
        a = fn(q, k, v).reshape(b, s, cfg.d_model)
        x = x + a @ attn.o_proj.kernel.to(dt)
        h = _rms_norm(x, self.mlp_norm.scale, cfg.rms_eps)
        gate = h @ mlp.gate_proj.kernel.to(dt)
        up = h @ mlp.up_proj.kernel.to(dt)
        return x + (F.silu(gate) * up) @ mlp.down_proj.kernel.to(dt)


class Llama(nn.Module):
    """tokens [B, S] int64 -> final-RMSNorm hidden states / logits / loss.

    Runs on ``device`` (CUDA by default; pass ``device="cpu"`` for the
    CPU). Weights are drawn from a ``torch.Generator`` seeded with
    ``seed`` with the reference's scheme: N(0, 0.02) embeddings, kernels
    N(0, 2 / (fan_in + fan_out)), unit norm scales."""

    def __init__(self, cfg: LlamaConfig,
                 device: "Optional[str | torch.device]" = None,
                 seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.tok_embed = _Param(embedding=(cfg.vocab_size, d))
        self.lm_head = _Param(kernel=(d, cfg.vocab_size))
        self.final_norm = _Param(scale=(d,))
        self.layers = nn.ModuleList(LlamaLayer(cfg)
                                    for _ in range(cfg.n_layers))
        self.to(device=resolve_device(device), dtype=cfg.param_dtype)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "embedding":
                init = torch.randn(p.shape, generator=gen) * 0.02
            elif leaf == "kernel":
                init = torch.randn(p.shape, generator=gen) * np.sqrt(
                    2.0 / (p.shape[0] + p.shape[1]))
            else:
                init = torch.ones(p.shape)
            p.copy_(init)

    def forward_hidden(self, tokens, attn_fn: Optional[Callable] = None):
        """tokens -> final-RMSNorm hidden states [B, S, d_model]."""
        cfg = self.cfg
        x = self.tok_embed.embedding.to(cfg.dtype)[tokens]
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(layer, x, attn_fn,
                                                      use_reentrant=False)
            else:
                x = layer(x, attn_fn)
        return _rms_norm(x, self.final_norm.scale, cfg.rms_eps)

    def forward(self, tokens, attn_fn: Optional[Callable] = None):
        """Logits [B, S, vocab] in f32 (the lm-head product in f32: logits
        feed log_softmax, and bf16 rounding there would move the loss)."""
        h = self.forward_hidden(tokens, attn_fn)
        return h.float() @ self.lm_head.kernel.float()

    def loss(self, tokens, targets, attn_fn: Optional[Callable] = None):
        """Mean next-token cross entropy."""
        if self.cfg.xent_chunks > 0:
            return hidden_cross_entropy(self.forward_hidden(tokens, attn_fn),
                                        self.lm_head.kernel, targets,
                                        self.cfg.xent_chunks)
        logp = torch.log_softmax(self.forward(tokens, attn_fn), dim=-1)
        return -logp.gather(-1, targets[..., None])[..., 0].mean()


def llama_init_params(cfg: LlamaConfig,
                      device: "Optional[str | torch.device]" = None,
                      seed: int = 0) -> Llama:
    """The model with freshly drawn weights (the reference's
    ``llama_init_params(cfg, key)``; the port's parameters live in the
    module)."""
    return Llama(cfg, device=device, seed=seed)


def llama_forward_hidden(cfg: LlamaConfig, model: Llama, tokens,
                         attn_fn: Optional[Callable] = None):
    assert model.cfg == cfg, "model was built for another config"
    return model.forward_hidden(tokens, attn_fn)


def llama_forward(cfg: LlamaConfig, model: Llama, tokens,
                  attn_fn: Optional[Callable] = None):
    assert model.cfg == cfg, "model was built for another config"
    return model(tokens, attn_fn)


def llama_loss_fn(cfg: LlamaConfig, model: Llama, tokens, targets,
                  attn_fn: Optional[Callable] = None):
    """Mean next-token cross entropy (twin of the reference's
    ``llama_loss_fn(cfg, params, tokens, targets, attn_fn=None)``)."""
    assert model.cfg == cfg, "model was built for another config"
    return model.loss(tokens, targets, attn_fn)


def llama_param_tree(model: Llama) -> Dict[str, Any]:
    """The model's parameters (the live tensors, detached) in the
    reference's pytree structure: nested dicts, ``layers`` a list.
    ``from_jax_params`` maps it back onto state-dict keys."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    tree["layers"] = [tree["layers"][str(i)]
                      for i in range(len(model.layers))]
    return tree
