"""GPT-style decoder-only transformer — the framework's flagship model.

Twin of ``torchft_tpu/models/transformer.py`` as an ``nn.Module``: the
parameters carry the JAX pytree's names and layouts (``layers_{i}/attn/
q_proj/kernel`` is the state-dict key ``layers_{i}.attn.q_proj.kernel``,
``[in, out]``), so ``from_jax_params`` maps one onto the other directly.

Numerics mirror the reference: f32 parameters, bf16 activations; layer norm
in f32 with the biased variance and eps 1e-5, cast back; embeddings cast to
bf16 before the gather; the tanh GELU; attention through
``ops.attention.causal_attention`` (the flash kernels on the GPU) unless the
caller passes ``attn_fn``, the reference's hook (a ring over the sequence
axis, ``parallel/ring.py``); the lm-head product and the loss in f32,
chunked over the vocab when ``xent_chunks`` > 0.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchft_tpu_torch.ops.attention import causal_attention
from torchft_tpu_torch.ops.xent import hidden_cross_entropy
from torchft_tpu_torch.utils.device import resolve_device

__all__ = ["CONFIGS", "GPT", "TrainStep", "TransformerConfig",
           "count_params", "from_jax_params", "loss_fn", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    # read nowhere, as in the reference: a ring reaches the model as attn_fn
    attention: str = "local"
    # > 0: the loss runs ops/xent.py's online logsumexp over this many
    # vocab chunks instead of materializing [B, S, V] logits
    xent_chunks: int = 0

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


CONFIGS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=256,
        max_seq_len=128, remat=False,
    ),
    "125m": TransformerConfig(
        vocab_size=32768, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
        max_seq_len=1024, xent_chunks=8, remat=False,
    ),
    "350m": TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
        max_seq_len=1024, xent_chunks=8,
    ),
    "1b": TransformerConfig(
        vocab_size=32768, d_model=2048, n_layers=24, n_heads=16, d_ff=8192,
        max_seq_len=2048, xent_chunks=8,
    ),
}


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


class _Param(nn.Module):
    """A module holding named parameters (``kernel``, ``embedding``,
    ``scale``/``bias``), so state-dict keys spell the JAX paths."""

    def __init__(self, **shapes) -> None:
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))


class _Attn(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, _Param(kernel=(d, d)))


class _MLP(nn.Module):
    def __init__(self, d: int, f: int) -> None:
        super().__init__()
        self.up_proj = _Param(kernel=(d, f))
        self.down_proj = _Param(kernel=(f, d))


def attn_sublayer(block: nn.Module, x, attn_fn: Optional[Callable] = None):
    """``x`` plus the causal self-attention of ``block`` (its ``ln_1`` and
    ``attn``), the half a dense and an MoE block share. ``attn_fn(q, k, v)``
    on ``[B, S, H, D]`` replaces ``causal_attention`` when given."""
    cfg, dt = block.cfg, block.cfg.dtype
    b, s, _ = x.shape
    h = _layer_norm(x, block.ln_1.scale, block.ln_1.bias)
    shape = (b, s, cfg.n_heads, cfg.head_dim)
    q = (h @ block.attn.q_proj.kernel.to(dt)).reshape(shape)
    k = (h @ block.attn.k_proj.kernel.to(dt)).reshape(shape)
    v = (h @ block.attn.v_proj.kernel.to(dt)).reshape(shape)
    attn = causal_attention if attn_fn is None else attn_fn
    a = attn(q, k, v).reshape(b, s, cfg.d_model)
    return x + a @ block.attn.o_proj.kernel.to(dt)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.ln_1 = _Param(scale=(d,), bias=(d,))
        self.attn = _Attn(d)
        self.ln_2 = _Param(scale=(d,), bias=(d,))
        self.mlp = _MLP(d, cfg.d_ff)

    def forward(self, x, attn_fn: Optional[Callable] = None):
        dt = self.cfg.dtype
        x = attn_sublayer(self, x, attn_fn)
        h = _layer_norm(x, self.ln_2.scale, self.ln_2.bias)
        h = F.gelu(h @ self.mlp.up_proj.kernel.to(dt), approximate="tanh")
        return x + h @ self.mlp.down_proj.kernel.to(dt)


class GPT(nn.Module):
    """tokens [B, S] int64 -> final-norm hidden states / loss.

    Runs on ``device`` (CUDA by default; pass ``device="cpu"`` for the
    CPU). Weights are drawn from ``torch.Generator`` seeded with ``seed``
    with the reference's scheme: N(0, 0.02) embeddings, N(0, 1/fan_in)
    kernels, unit/zero layer norms."""

    def __init__(self, cfg: TransformerConfig,
                 device: "Optional[str | torch.device]" = None,
                 seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.wte = _Param(embedding=(cfg.vocab_size, d))
        self.wpe = _Param(embedding=(cfg.max_seq_len, d))
        self.ln_f = _Param(scale=(d,), bias=(d,))
        self.lm_head = _Param(kernel=(d, cfg.vocab_size))
        for i in range(cfg.n_layers):
            self.add_module(f"layers_{i}", self._block(i))
        self.to(device=resolve_device(device), dtype=cfg.param_dtype)
        self.reset_parameters(seed)

    def _block(self, i: int) -> nn.Module:
        return Block(self.cfg)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "embedding":
                init = torch.randn(p.shape, generator=gen) * 0.02
            elif leaf == "kernel":
                init = torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[0])
            elif leaf in ("up", "down"):  # experts [E, in, out]
                init = torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[1])
            elif leaf == "scale":
                init = torch.ones(p.shape)
            else:
                init = torch.zeros(p.shape)
            p.copy_(init)

    def blocks(self):
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.n_layers)]

    def forward_hidden(self, tokens, attn_fn: Optional[Callable] = None):
        """Final-norm hidden states; ``attn_fn`` as for
        :func:`attn_sublayer`."""
        dt = self.cfg.dtype
        s = tokens.shape[1]
        x = self.wte.embedding.to(dt)[tokens]
        x = x + self.wpe.embedding.to(dt)[:s][None, :, :]
        for block in self.blocks():
            if self.cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(block, x, attn_fn,
                                                      use_reentrant=False)
            else:
                x = block(x, attn_fn)
        return _layer_norm(x, self.ln_f.scale, self.ln_f.bias)

    def forward(self, tokens, attn_fn: Optional[Callable] = None):
        """Logits [B, S, vocab] in f32."""
        h = self.forward_hidden(tokens, attn_fn)
        return h.float() @ self.lm_head.kernel.float()

    def cross_entropy(self, h, targets):
        """Mean next-token cross entropy of final-norm hidden states ``h``
        (the reference's ``ce_from_hidden``)."""
        w = self.lm_head.kernel
        if self.cfg.xent_chunks > 0:
            return hidden_cross_entropy(h, w, targets, self.cfg.xent_chunks)
        logp = torch.log_softmax(h.float() @ w.float(), dim=-1)
        return -logp.gather(-1, targets[..., None])[..., 0].mean()

    def loss(self, tokens, targets, attn_fn: Optional[Callable] = None):
        """Mean next-token cross entropy."""
        return self.cross_entropy(self.forward_hidden(tokens, attn_fn),
                                  targets)


def loss_fn(cfg: TransformerConfig, model: GPT, tokens, targets,
            attn_fn: Optional[Callable] = None):
    """Mean next-token cross entropy (twin of the reference's
    ``loss_fn(cfg, params, tokens, targets, attn_fn=None)``)."""
    assert model.cfg == cfg, "model was built for another config"
    return model.loss(tokens, targets, attn_fn)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def from_jax_params(params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX package's parameter pytree (nested dicts and lists of
    numpy arrays, as ``jax.device_get(init_params(...))`` gives) onto a
    state dict for :class:`GPT` or ``models.llama.Llama``: path ``a/b/c``
    becomes key ``a.b.c`` and list entry ``i`` of ``layers`` key
    ``layers.i``; kernels keep their ``[in, out]`` layout. Torch tensors
    are taken as they are (on their device, in their dtype); anything else
    becomes an f32 CPU tensor."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        elif isinstance(node, torch.Tensor):
            out[prefix] = node
            return
        else:
            out[prefix] = torch.from_numpy(np.array(node, dtype=np.float32))
            return
        for k, v in items:
            walk(f"{prefix}.{k}" if prefix else str(k), v)

    walk("", params_np)
    return out


# One CUDA graph capture at a time in a process: entering a capture
# synchronizes the device and empties the allocator's cache, which would
# invalidate a capture in flight on another thread.
_CAPTURE_LOCK = threading.Lock()


class TrainStep:
    """``(tokens, targets) -> loss``: forward, backward and
    ``optimizer.step()`` on the model's own tensors, in place (twin of the
    reference's jitted, donated ``make_train_step``).

    On CUDA the step is one CUDA graph, the port's counterpart of one
    donated XLA program. The first call (and the first after the
    parameters or the optimizer state were replaced by new tensors) warms
    up on a side stream, puts the parameters and optimizer state back as
    they were, and captures forward, backward and update with static token
    and target buffers and the loss as a static output; every call then
    copies its batch in and replays. A capture or replay failure raises:
    there is no eager fallback on CUDA. Other threads (another replica
    group) may keep launching while one captures, but none may synchronize
    the whole device (``torch.cuda.synchronize``): that invalidates the
    capture; synchronize a stream instead. The optimizer must keep its step
    count on the device (Adam or AdamW with ``capturable=True``).

    Loading a state into the same tensors in place (``nn.Module.
    load_state_dict``, ``optim.load_optimizer_state_dict``) keeps the graph;
    anything that replaces them makes the next call re-capture.

    On the CPU the step runs eagerly (tests). ``warmup_passes`` counts the
    eager forward/backward passes the captures ran; ``captures`` the
    graphs captured. The flash wrappers' launches a capture records are
    added to their counts at every replay."""

    def __init__(self, model: "GPT", optimizer: torch.optim.Optimizer) -> None:
        self.model = model
        self.optimizer = optimizer
        self.device = next(model.parameters()).device
        self.captures = 0
        self.warmup_passes = 0
        self._graph = None
        self._stream = None
        self._tokens = self._targets = self._loss = None
        self._tally: Dict[str, int] = {}
        self._key: Optional[tuple] = None
        if self.device.type == "cuda":
            if not isinstance(optimizer, (torch.optim.Adam,
                                          torch.optim.AdamW)):
                raise TypeError(
                    "a CUDA train step captures Adam or AdamW (their lazy "
                    f"state starts at zero), not {type(optimizer).__name__}"
                )
            if not all(g.get("capturable") for g in optimizer.param_groups):
                raise ValueError(
                    "a CUDA train step needs the optimizer's step count on "
                    "the device: build it with capturable=True"
                )

    def _state_key(self) -> tuple:
        """Addresses of every tensor the graph reads or updates in place."""
        ptrs = []
        for p in self.model.parameters():
            ptrs.append(p.data_ptr())
            for v in self.optimizer.state.get(p, {}).values():
                if isinstance(v, torch.Tensor):
                    ptrs.append(v.data_ptr())
        return tuple(ptrs)

    def _eager(self, tokens, targets):
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.loss(tokens, targets)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def _restore(self, params, saved_params, saved_state) -> None:
        for p, saved in zip(params, saved_params):
            p.copy_(saved)
        for p in params:
            old = saved_state.get(p)
            for k, v in self.optimizer.state.get(p, {}).items():
                if not isinstance(v, torch.Tensor):
                    continue
                if old is None:
                    v.zero_()  # Adam's lazy state starts at zero
                else:
                    v.copy_(old[k])

    def _capture(self, tokens, targets) -> None:
        from torchft_tpu_torch.ops import flash

        self._graph = None
        params = list(self.model.parameters())
        saved_params = [p.detach().clone() for p in params]
        saved_state = {
            p: {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in self.optimizer.state[p].items()}
            for p in params if self.optimizer.state.get(p)
        }
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side, cur = self._stream, torch.cuda.current_stream(self.device)
        self._tokens = tokens.clone()
        self._targets = targets.clone()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # lazy state, cuBLAS workspaces and autograd's stream state come
            # into being here, on the capture's stream, outside the capture
            self._eager(self._tokens, self._targets)
            self.warmup_passes += 1
        cur.wait_stream(side)
        for p in params:  # state born on the side stream, used on this one
            for v in self.optimizer.state.get(p, {}).values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(cur)
        self._restore(params, saved_params, saved_state)
        self.optimizer.zero_grad(set_to_none=True)
        del saved_params, saved_state
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        tally: Dict[str, int] = {}
        with _CAPTURE_LOCK, flash.recording_launches(tally, side):
            # thread_local: another replica group's thread may keep
            # launching while this one captures
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                loss = self.model.loss(self._tokens, self._targets)
                loss.backward()
                self.optimizer.step()
        cur.wait_stream(side)
        self._loss = loss.detach()
        self._graph, self._tally = graph, tally
        self._key = self._state_key()
        self.captures += 1

    def sync_state(self) -> None:
        """Drop the graph if the parameters or optimizer state are no
        longer the tensors it captured (a load that replaced them); the
        next call re-captures."""
        if self._graph is not None and self._state_key() != self._key:
            self._graph = None

    def __call__(self, tokens: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return self._eager(tokens, targets)
        from torchft_tpu_torch.ops import flash

        self.sync_state()
        if self._graph is None or tokens.shape != self._tokens.shape:
            self._capture(tokens, targets)
        else:
            self._tokens.copy_(tokens)
            self._targets.copy_(targets)
        self._graph.replay()
        flash.add_launches(self._tally)
        # the static loss is overwritten by the next replay
        return self._loss.clone()


def make_train_step(model: "GPT",
                    optimizer: torch.optim.Optimizer) -> TrainStep:
    """The fused step of a solo wire: ``(tokens, targets) -> loss`` with
    forward, backward and the update in one CUDA graph on the card (see
    :class:`TrainStep`). Cross-replica averaging never happens inside it,
    so quorum changes never re-capture."""
    return TrainStep(model, optimizer)
