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

:class:`ShardedMoETransformer` is the same model over an in-group mesh's
``data``, ``tensor`` and ``expert`` axes, built on ``ShardedGPT``'s
lock-step machinery: the leaves cut by ``tp_rules_gpt() + moe_rules()``
(the reference's single pass: attention and the dense MLPs Megatron-split
on ``tensor``, the experts' ``up``/``down`` on their expert dimension over
``expert``, the router whole), the batch split over ``data`` x ``expert``
(GShard's layout, so no position repeats another's attention), and each
MoE layer through ``parallel.moe.sharded_moe_forward`` (global routing,
the dispatch and combine all-to-alls over the expert axis).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from torchft_tpu_torch.models.transformer import (
    GPT,
    Block,
    ShardedGPT,
    TransformerConfig,
    _Attn,
    _layer_norm,
    _Param,
    attn_sublayer,
    gpt_param_shapes,
)
from torchft_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
)
from torchft_tpu_torch.parallel.moe import (
    ExpertPlan,
    MoEConfig,
    moe_forward,
    moe_rules,
    sharded_moe_forward,
)
from torchft_tpu_torch.parallel.sharding import NamedSharding, tp_rules_gpt

__all__ = ["MOE_CONFIGS", "MoEBlock", "MoETransformer",
           "MoETransformerConfig", "ShardedMoETransformer",
           "moe_param_shapes"]


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

    def forward(self, x, attn_fn: Optional[Callable] = None):
        x = attn_sublayer(self, x, attn_fn)
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

    def forward_hidden_aux(self, tokens, attn_fn: Optional[Callable] = None):
        """(final-norm hidden states [B, S, D], the summed aux loss);
        ``attn_fn`` replaces ``causal_attention`` when given."""
        dt = self.cfg.dtype
        s = tokens.shape[1]
        x = self.wte.embedding.to(dt)[tokens]
        x = x + self.wpe.embedding.to(dt)[:s][None, :, :]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(self.blocks()):
            if self.cfg.remat and torch.is_grad_enabled():
                out = torch.utils.checkpoint.checkpoint(block, x, attn_fn,
                                                        use_reentrant=False)
            else:
                out = block(x, attn_fn)
            if self.moe_config.is_moe_layer(i):
                x, aux = out
                aux_total = aux_total + aux.float()
            else:
                x = out
        return _layer_norm(x, self.ln_f.scale, self.ln_f.bias), aux_total

    def forward_hidden(self, tokens, attn_fn: Optional[Callable] = None):
        return self.forward_hidden_aux(tokens, attn_fn)[0]

    def loss(self, tokens, targets, attn_fn: Optional[Callable] = None):
        """Mean next-token cross entropy + aux_loss_weight x the summed
        load-balancing losses."""
        h, aux = self.forward_hidden_aux(tokens, attn_fn)
        return (self.cross_entropy(h, targets)
                + self.moe_config.aux_loss_weight * aux)


def moe_param_shapes(cfg: MoETransformerConfig) -> Dict[str, tuple]:
    """Every parameter's path (the reference's) and shape, in
    ``MoETransformer.named_parameters()`` order: the dense skeleton's, each
    MoE layer's ``mlp`` replaced by ``moe/gate/kernel`` [D, E] and
    ``moe/experts/{up,down}`` [E, D, F] and [E, F, D]."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    out: Dict[str, tuple] = {}
    for path, shape in gpt_param_shapes(cfg.dense_cfg()).items():
        layer, *rest = path.split("/")
        if rest[0] == "mlp" and cfg.is_moe_layer(int(layer[len("layers_"):])):
            if rest[1] == "up_proj":
                out.update({f"{layer}/moe/gate/kernel": (d, e),
                            f"{layer}/moe/experts/up": (e, d, f),
                            f"{layer}/moe/experts/down": (e, f, d)})
            continue
        out[path] = shape
    return out


class ShardedMoETransformer(ShardedGPT):
    """The MoE transformer over an in-group mesh's ``data``, ``tensor`` and
    ``expert`` axes (see the module docstring): tokens [B, S] -> the mean
    next-token cross entropy plus ``aux_loss_weight`` x the summed
    load-balancing losses, equal to :class:`MoETransformer`'s on the same
    weights up to the order of the row-parallel, vocab-parallel and combine
    sums. ``num_experts`` must split over ``expert``, and ``n_heads``,
    ``d_ff`` and the vocabulary over ``tensor``; the batch splits over
    ``data`` x ``expert``. An ``fsdp`` axis is refused (the reference's MoE
    runs with ``fsdp_axis=None``). ``params``: a tree in the reference's
    structure (``jax.device_get(moe_init_params(...))`` or
    ``gpt_param_tree(moe_transformer)``), or None to draw the weights with
    :class:`MoETransformer`'s scheme from ``seed``. ``state_tree``,
    ``grad_tree`` and ``load_state_tree`` are ``ShardedGPT``'s: the expert
    leaves are ``ShardedTensor`` s split on their expert dimension."""

    _BATCH_AXES = (AXIS_DATA, AXIS_EXPERT)
    _MOE_LEAVES = ("moe/gate/kernel", "moe/experts/up", "moe/experts/down")

    def __init__(self, cfg: MoETransformerConfig, mesh, params=None,
                 seed: int = 0) -> None:
        shape = (getattr(mesh, "mesh", None) or mesh).shape
        if shape.get(AXIS_FSDP, 1) > 1:
            raise ValueError(f"the expert-sharded MoE takes no {AXIS_FSDP} "
                             f"axis (mesh {shape}); the reference's MoE runs "
                             f"with fsdp_axis=None")
        ep = shape.get(AXIS_EXPERT, 1)
        if cfg.num_experts % ep:
            raise ValueError(f"{cfg.num_experts} experts do not split over "
                             f"{AXIS_EXPERT} = {ep}")
        self.moe_config = cfg
        super().__init__(cfg, mesh, params=params, seed=seed)
        self.expert_plan = ExpertPlan(self.mesh, self._BATCH_AXES)

    def _param_shapes(self) -> Dict[str, tuple]:
        return moe_param_shapes(self.moe_config)

    def _rules(self) -> list:
        return tp_rules_gpt() + moe_rules()

    def _check_layout(self, path: str, sharding: NamedSharding) -> None:
        """Megatron's layout on ``tensor``; on ``expert`` only the experts,
        split on their expert dimension."""
        super()._check_layout(path, sharding)
        got = [i for i, e in enumerate(sharding.spec) if e == AXIS_EXPERT]
        expert_leaf = path.rsplit("/", 2)[-2:] in (["experts", "up"],
                                                   ["experts", "down"])
        if got != ([0] if expert_leaf and self.mesh.shape.get(
                AXIS_EXPERT, 1) > 1 else []):
            raise ValueError(f"{path}: spec {sharding.spec} is not the "
                             f"expert layout the sharded MoE computes")

    def _moe_block(self, i: int, *xs):
        w = self._gather_layer(i, self._ATTN_LEAVES + self._MOE_LEAVES)
        xs = self._attention(w, xs)
        d = self.cfg.d_model
        hs = [_layer_norm(x, w["ln_2/scale"][p], w["ln_2/bias"][p])
              .reshape(-1, d) for p, x in enumerate(xs)]
        ys, aux = sharded_moe_forward(
            self.moe_config.moe_cfg(), self.expert_plan,
            w["moe/gate/kernel"], w["moe/experts/up"],
            w["moe/experts/down"], hs)
        # over-capacity tokens get 0: the residual passes them through
        return (*(x + y.reshape(x.shape) for x, y in zip(xs, ys)),
                aux.float())

    def _layer(self, i: int, xs):
        if not self.moe_config.is_moe_layer(i):
            return super()._layer(i, xs)
        if self.cfg.remat and torch.is_grad_enabled():
            out = torch.utils.checkpoint.checkpoint(
                self._moe_block, i, *xs,
                use_reentrant=self._remat_reentrant)
        else:
            out = self._moe_block(i, *xs)
        return out[:-1], out[-1]

    def loss(self, tokens, targets) -> torch.Tensor:
        """Mean next-token cross entropy + aux_loss_weight x the summed
        load-balancing losses, on the first position's device."""
        hs, aux = self.forward_hidden_aux(tokens)
        return (self.cross_entropy(hs, targets)
                + self.moe_config.aux_loss_weight * aux)
