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

:class:`ShardedGPT` is the same model with its parameters sharded over the
``fsdp`` and ``tensor`` axes of an in-group mesh (``parallel/sharding.py``,
``tp_rules_gpt``). The reference leaves that partitioning to XLA
(``make_grad_step`` on ``shard_pytree`` d parameters); here the mesh's
positions run in lock-step in one process, each on its own device, and the
collectives are explicit autograd functions that add contributions in a
fixed position order, so two replica groups stay bitwise equal:

- the batch splits over the ``data`` x ``fsdp`` coordinates;
- ``fsdp``: each layer gathers its pieces on every position's device when
  it runs, inside the remat region, so the backward gathers again rather
  than keeping whole weights; the gather's backward is the reduce-scatter
  into the pieces (every copy of a region gets the sum over all positions
  that used it, in position order);
- ``tensor``, Megatron's layout: q/k/v and the MLP's up projection
  column-parallel, so each position attends over its own ``n_heads / tp``
  heads through ``causal_attention`` (the flash kernels on the card); the
  attention's output and the MLP's down projection row-parallel, their
  partial sums added in position order; the token embedding a masked
  gather per vocab shard, summed; the lm head through
  ``ops.xent.vocab_parallel_nll``.

Its parameters are the pieces (``nn.Parameter`` s), so ``torch.optim`` and
``ddp.DistributedDataParallel`` see plain tensors; ``state_tree`` views
them (and an optimizer's moments) as ``ShardedTensor`` leaves for the heal.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchft_tpu_torch.ops.attention import causal_attention
from torchft_tpu_torch.ops.xent import hidden_cross_entropy, vocab_parallel_nll
from torchft_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_FSDP, AXIS_TENSOR
from torchft_tpu_torch.parallel.sharding import (
    NamedSharding,
    ShardedTensor,
    _device,
    make_sharding_fn,
    tp_rules_gpt,
)
from torchft_tpu_torch.utils.device import resolve_device

__all__ = ["CONFIGS", "GPT", "ShardedGPT", "TrainStep", "TransformerConfig",
           "ce_from_hidden", "count_params", "from_jax_params",
           "gpt_param_shapes", "gpt_param_tree", "layer_tree", "loss_fn",
           "make_grad_step", "make_train_step"]


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


def _init_tensor(leaf: str, shape, gen: torch.Generator,
                 device: "str | torch.device" = "cpu") -> torch.Tensor:
    """The reference's draw for a parameter named ``leaf``: N(0, 0.02)
    embeddings, N(0, 1/fan_in) kernels (experts ``[E, in, out]`` too),
    unit scales, zero biases."""
    if leaf == "embedding":
        return torch.randn(shape, generator=gen, device=device) * 0.02
    if leaf == "kernel":
        return torch.randn(shape, generator=gen, device=device) \
            / np.sqrt(shape[0])
    if leaf in ("up", "down"):
        return torch.randn(shape, generator=gen, device=device) \
            / np.sqrt(shape[1])
    if leaf == "scale":
        return torch.ones(shape, device=device)
    return torch.zeros(shape, device=device)


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


def layer_tree(module: nn.Module) -> Dict[str, Any]:
    """``module``'s parameters (the live tensors) as a dict tree in the
    reference's ``layers_i`` structure: ``{"ln_1": {"scale": ...},
    "attn": {"q_proj": {"kernel": ...}}, ...}``."""
    tree: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        _tree_set(tree, name.replace(".", "/"), p)
    return tree


def _attn_sublayer(cfg, layer: Dict[str, Any], x,
                   attn_fn: Optional[Callable] = None):
    """``x`` plus the causal self-attention of ``layer`` (its ``ln_1`` and
    ``attn`` tensors), the half a dense and an MoE block share. ``cfg`` is
    duck-typed (dtype, n_heads, head_dim, d_model). ``attn_fn(q, k, v)``
    on ``[B, S, H, D]`` replaces ``causal_attention`` when given."""
    dt = cfg.dtype
    b, s, _ = x.shape
    h = _layer_norm(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"])
    shape = (b, s, cfg.n_heads, cfg.head_dim)
    w = layer["attn"]
    q = (h @ w["q_proj"]["kernel"].to(dt)).reshape(shape)
    k = (h @ w["k_proj"]["kernel"].to(dt)).reshape(shape)
    v = (h @ w["v_proj"]["kernel"].to(dt)).reshape(shape)
    attn = causal_attention if attn_fn is None else attn_fn
    a = attn(q, k, v).reshape(b, s, cfg.d_model)
    return x + a @ w["o_proj"]["kernel"].to(dt)


def _block(cfg: TransformerConfig, layer: Dict[str, Any], x, *,
           attn_fn: Optional[Callable] = None):
    """One decoder block over ``layer``, a dict of tensors in the
    reference's ``layers_i`` tree (twin of the reference's ``_block``): a
    stage of a pipeline runs a range of layers from stacked leaves with
    it, and :class:`Block` runs its own parameters through it."""
    dt = cfg.dtype
    x = _attn_sublayer(cfg, layer, x, attn_fn)
    h = _layer_norm(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"])
    h = F.gelu(h @ layer["mlp"]["up_proj"]["kernel"].to(dt),
               approximate="tanh")
    return x + h @ layer["mlp"]["down_proj"]["kernel"].to(dt)


def attn_sublayer(block: nn.Module, x, attn_fn: Optional[Callable] = None):
    """:func:`_attn_sublayer` over ``block``'s own parameters."""
    return _attn_sublayer(block.cfg, layer_tree(block), x, attn_fn)


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
        return _block(self.cfg, layer_tree(self), x, attn_fn=attn_fn)


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
            p.copy_(_init_tensor(name.rsplit(".", 1)[-1], p.shape, gen))

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
        (:func:`ce_from_hidden` over the model's head)."""
        return ce_from_hidden(h, self.lm_head.kernel, targets,
                              self.cfg.xent_chunks)

    def loss(self, tokens, targets, attn_fn: Optional[Callable] = None):
        """Mean next-token cross entropy."""
        return self.cross_entropy(self.forward_hidden(tokens, attn_fn),
                                  targets)


def ce_from_hidden(h, lm_head_kernel, targets, xent_chunks: int = 0):
    """Mean next-token cross entropy from final-norm hidden states (twin
    of the reference's ``ce_from_hidden``): ``xent_chunks`` > 0 runs
    ``ops.xent.hidden_cross_entropy``'s online logsumexp over that many
    vocab chunks, 0 the dense f32 log-softmax. The head is replicated."""
    if xent_chunks > 0:
        return hidden_cross_entropy(h, lm_head_kernel, targets, xent_chunks)
    logp = torch.log_softmax(h.float() @ lm_head_kernel.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


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


def make_grad_step(model: nn.Module, attn_fn: Optional[Callable] = None,
                   microbatches: int = 1) -> Callable:
    """``(tokens, targets) -> loss`` leaving the batch's mean gradient in
    each parameter's ``.grad`` (replacing what was there), where
    ``DistributedDataParallel`` reads it: the FT-DDP path's on-device half
    (twin of the reference's ``make_grad_step``; ``model`` is any of the
    port's models with a ``loss(tokens, targets)``, ``attn_fn`` as for
    :func:`attn_sublayer`).

    ``microbatches`` > 1 runs that many equal slices of the batch one after
    another (the activations of one slice at a time), accumulates the loss
    and the gradients in f32 and hands back their means, the gradients
    cast to each parameter's dtype, as the reference's scan does; a batch
    that does not divide raises ValueError."""
    params = [p for p in model.parameters() if p.requires_grad]

    def loss_of(tokens, targets):
        if attn_fn is None:
            return model.loss(tokens, targets)
        return model.loss(tokens, targets, attn_fn)

    def step(tokens, targets):
        if microbatches <= 1:
            loss = loss_of(tokens, targets)
            grads = torch.autograd.grad(loss, params)
            for p, g in zip(params, grads):
                p.grad = g
            return loss.detach()
        b = tokens.shape[0]
        if b % microbatches:
            raise ValueError(
                f"batch {b} not divisible by microbatches {microbatches}")
        mb = b // microbatches
        loss_sum = None
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
        for i in range(microbatches):
            sl = slice(i * mb, (i + 1) * mb)
            loss = loss_of(tokens[sl], targets[sl])
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for a, g in zip(acc, grads):
                a.add_(g.float())
        inv = 1.0 / microbatches
        for p, a in zip(params, acc):
            p.grad = (a * inv).to(p.dtype)
        return loss_sum * inv

    return step


# ----------------------------------------------------------- sharded GPT


def _tree_set(tree: Dict[str, Any], path: str, value: Any) -> None:
    *keys, leaf = path.split("/")
    for k in keys:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def _tree_get(tree: Any, path: str) -> Any:
    for k in path.split("/"):
        tree = tree[k]
    return tree


def gpt_param_tree(model: GPT) -> Dict[str, Any]:
    """The model's parameters (the live tensors, detached) in the
    reference's pytree structure: ``{"wte": {"embedding": ...},
    "layers_0": {"attn": {"q_proj": {"kernel": ...}}}, ...}``."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        _tree_set(tree, name.replace(".", "/"), p.detach())
    return tree


def gpt_param_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Every parameter's path (the reference's) and shape, in
    ``GPT.named_parameters()`` order."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    out = {"wte/embedding": (v, d), "wpe/embedding": (cfg.max_seq_len, d),
           "ln_f/scale": (d,), "ln_f/bias": (d,), "lm_head/kernel": (d, v)}
    for i in range(cfg.n_layers):
        out.update({
            f"layers_{i}/ln_1/scale": (d,), f"layers_{i}/ln_1/bias": (d,),
            f"layers_{i}/attn/q_proj/kernel": (d, d),
            f"layers_{i}/attn/k_proj/kernel": (d, d),
            f"layers_{i}/attn/v_proj/kernel": (d, d),
            f"layers_{i}/attn/o_proj/kernel": (d, d),
            f"layers_{i}/ln_2/scale": (d,), f"layers_{i}/ln_2/bias": (d,),
            f"layers_{i}/mlp/up_proj/kernel": (d, f),
            f"layers_{i}/mlp/down_proj/kernel": (f, d)})
    return out


# the dimension tp_rules_gpt splits over the tensor axis, by leaf name
_TENSOR_DIM = {"wte/embedding": 0, "lm_head/kernel": 1, "q_proj/kernel": 1,
               "k_proj/kernel": 1, "v_proj/kernel": 1, "o_proj/kernel": 0,
               "up_proj/kernel": 1, "down_proj/kernel": 0}


class _GatherPlan:
    """How one leaf's pieces assemble on each mesh position: the
    position's region is its piece's bounds with the fsdp dimension whole,
    concatenated from the pieces of the positions that differ from it on
    the fsdp axis alone, in fsdp order."""

    def __init__(self, shard: ShardedTensor) -> None:
        mesh = shard.sharding.mesh
        grid, names = mesh.devices.shape, mesh.axis_names
        spec = shard.sharding.spec
        self.dim = spec.index(AXIS_FSDP) if AXIS_FSDP in spec else None
        self.devices = [_device(d) for d in mesh.devices.flat]
        self.piece_devices = list(shard.devices)
        self.sources: List[List[int]] = []
        for pos in range(mesh.size):
            if self.dim is None:
                self.sources.append([shard._index[pos]])
                continue
            coord = list(np.unravel_index(pos, grid))
            axis = names.index(AXIS_FSDP)
            srcs = []
            for c in range(grid[axis]):
                coord[axis] = c
                srcs.append(shard._index[int(np.ravel_multi_index(coord,
                                                                   grid))])
            self.sources.append(srcs)
        self.block = (shard.bounds[0][self.dim][1]
                      - shard.bounds[0][self.dim][0]) \
            if self.dim is not None else None
        # the copies of each distinct region, and every (position, slot)
        # that used one of them, in position order
        group_of: Dict[tuple, int] = {}
        for b in shard.bounds:
            group_of.setdefault(b, len(group_of))
        self.groups: List[List[int]] = [[] for _ in group_of]
        for j, b in enumerate(shard.bounds):
            self.groups[group_of[b]].append(j)
        self.users: List[List[Tuple[int, int]]] = [[] for _ in self.groups]
        for pos, srcs in enumerate(self.sources):
            for k, j in enumerate(srcs):
                self.users[group_of[shard.bounds[j]]].append((pos, k))


class _Gather(torch.autograd.Function):
    """fsdp all-gather of one leaf onto every mesh position; the backward
    is the reduce-scatter, in position order, into every copy."""

    @staticmethod
    def forward(ctx, plan: _GatherPlan, *pieces):
        ctx.plan = plan
        ctx.shapes = [(p.shape, p.dtype) for p in pieces]
        outs = []
        for pos, srcs in enumerate(plan.sources):
            dev = plan.devices[pos]
            parts = [pieces[j].to(dev) for j in srcs]
            outs.append(torch.cat(parts, plan.dim) if len(parts) > 1
                        else parts[0].clone())
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        out: List[Optional[torch.Tensor]] = [None] * len(ctx.shapes)
        for group, users in zip(plan.groups, plan.users):
            root = plan.piece_devices[group[0]]
            acc = None
            for pos, k in users:
                g = grads[pos]
                if g is None:
                    continue
                if plan.dim is not None:
                    g = g.narrow(plan.dim, k * plan.block, plan.block)
                g = g.to(root)
                acc = g if acc is None else acc + g
            for j in group:
                shape, dtype = ctx.shapes[j]
                out[j] = torch.zeros(shape, dtype=dtype,
                                     device=plan.piece_devices[j]) \
                    if acc is None \
                    else acc.to(plan.piece_devices[j]).contiguous()
        return (None, *out)


class _AllReduce(torch.autograd.Function):
    """Sum of the partials of one tensor-axis group on each of its
    positions' devices, added in position order; the backward sums the
    outputs' gradients the same way onto each partial's device."""

    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.part_devices = [p.device for p in parts]
        ctx.devices = devices
        outs = []
        for dev in devices:
            acc = parts[0].to(dev)
            for p in parts[1:]:
                acc = acc + p.to(dev)
            outs.append(acc)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for dev in ctx.part_devices:
            acc = None
            for g in grads:
                if g is None:
                    continue
                g = g.to(dev)
                acc = g if acc is None else acc + g
            out.append(acc)
        return (None, *out)


class ShardedGPT(nn.Module):
    """The GPT over an in-group mesh's ``fsdp`` and ``tensor`` axes (see the
    module docstring): tokens [B, S] -> the mean next-token cross entropy,
    equal to :class:`GPT`'s on the same weights up to the order of the
    row-parallel and vocab-parallel sums.

    ``mesh``: a ``parallel.mesh.Mesh`` (or an ``FTMesh``) with any of the
    axes ``data``, ``fsdp`` and ``tensor``; ``n_heads``, ``d_ff`` and the
    vocabulary split over ``tensor``, the batch over ``data`` x ``fsdp``.
    ``params``: the whole leaves to start from, a tree in the reference's
    structure (``jax.device_get(init_params(...))`` or
    :func:`gpt_param_tree`), each cut into its pieces as ``shard_pytree``
    cuts it; None draws them with :class:`GPT`'s scheme from a generator
    seeded with ``seed`` on the first position's device, one leaf at a
    time."""

    # the axes the batch splits over, the first the major
    _BATCH_AXES: Tuple[str, ...] = (AXIS_DATA, AXIS_FSDP)

    def __init__(self, cfg: TransformerConfig, mesh, params: Any = None,
                 seed: int = 0) -> None:
        super().__init__()
        mesh = getattr(mesh, "mesh", None) or mesh
        self.cfg, self.mesh = cfg, mesh
        shape = mesh.shape
        self.tp = shape.get(AXIS_TENSOR, 1)
        self.devices = [_device(d) for d in mesh.devices.flat]
        # Autograd runs each card's backward on a thread of its own, and a
        # non-reentrant checkpoint recomputes its region from whichever
        # thread first unpacks a saved tensor: over several cards two
        # threads race to recompute one region (torch.utils.checkpoint's
        # early stop then asserts). There the region recomputes inside its
        # own backward node, once (reentrant).
        self._remat_reentrant = len({str(d) for d in self.devices}) > 1
        coords = [dict(zip(mesh.axis_names, map(int, np.unravel_index(
            p, mesh.devices.shape)))) for p in range(mesh.size)]
        self.batch_shards = int(np.prod([shape.get(a, 1)
                                         for a in self._BATCH_AXES]))
        self._batch_index = []
        for c in coords:
            b = 0
            for a in self._BATCH_AXES:
                b = b * shape.get(a, 1) + c.get(a, 0)
            self._batch_index.append(b)
        self._tensor_index = [c.get(AXIS_TENSOR, 0) for c in coords]
        # positions grouped by batch shard, each group in tensor order
        self._groups: List[List[int]] = [[] for _ in range(self.batch_shards)]
        for p, b in enumerate(self._batch_index):
            self._groups[b].append(p)
        if self.tp > 1 and (cfg.n_heads % self.tp or cfg.d_ff % self.tp
                            or cfg.vocab_size % self.tp):
            raise ValueError(f"n_heads {cfg.n_heads}, d_ff {cfg.d_ff} and "
                             f"vocab {cfg.vocab_size} must split over "
                             f"{AXIS_TENSOR} = {self.tp}")
        fn = make_sharding_fn(mesh, self._rules())
        gen = None
        if params is None:
            gen = torch.Generator(device=self.devices[0]).manual_seed(seed)
        shapes = self._param_shapes()
        self.paths = list(shapes)
        self.layouts: Dict[str, ShardedTensor] = {}
        self.plans: Dict[str, _GatherPlan] = {}
        self.shards = nn.ModuleDict()
        for path, want in shapes.items():
            whole = _tree_get(params, path) if gen is None \
                else _init_tensor(path.rsplit("/", 1)[-1], want, gen,
                                  self.devices[0])
            if tuple(whole.shape) != want:
                raise ValueError(f"{path}: {tuple(whole.shape)}, the config "
                                 f"wants {want}")
            sharding = fn(path, whole)
            self._check_layout(path, sharding)
            leaf = ShardedTensor.from_full(whole, sharding,
                                           dtype=cfg.param_dtype)
            del whole
            self.layouts[path] = leaf
            self.plans[path] = _GatherPlan(leaf)
            self.shards[path.replace("/", "-")] = nn.ParameterList(
                [nn.Parameter(p) for p in leaf.pieces])

    def _param_shapes(self) -> Dict[str, tuple]:
        return gpt_param_shapes(self.cfg)

    def _rules(self) -> list:
        return tp_rules_gpt()

    # ------------------------------------------------------------ layout

    def _check_layout(self, path: str, sharding: NamedSharding) -> None:
        """The model computes Megatron's layout: the tensor axis may split
        only the dimension ``tp_rules_gpt`` gives each leaf."""
        spec = sharding.spec
        name = "/".join(path.split("/")[-2:])
        want = _TENSOR_DIM.get(name) if self.tp > 1 else None
        got = [i for i, e in enumerate(spec) if e == AXIS_TENSOR]
        if got != ([] if want is None else [want]):
            raise ValueError(f"{path}: spec {spec} is not the layout the "
                             f"sharded GPT computes")

    def pieces(self, path: str) -> List[torch.Tensor]:
        """The parameters holding leaf ``path``'s pieces."""
        return list(self.shards[path.replace("/", "-")])

    def _gather(self, path: str) -> Tuple[torch.Tensor, ...]:
        return _Gather.apply(self.plans[path], *self.pieces(path))

    def _allreduce(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Row-parallel partials (one per position) summed over each
        tensor-axis group."""
        if self.tp == 1:
            return parts
        out: List[Optional[torch.Tensor]] = [None] * len(parts)
        for group in self._groups:
            summed = _AllReduce.apply([self.devices[p] for p in group],
                                      *[parts[p] for p in group])
            for p, y in zip(group, summed):
                out[p] = y
        return out

    # ------------------------------------------------------------- model

    def _attention(self, w: Dict[str, Tuple[torch.Tensor, ...]], xs):
        """Each position's hidden states plus the attention sublayer of the
        layer whose gathered leaves are ``w``."""
        cfg, dt = self.cfg, self.cfg.dtype
        parts = []
        for p, x in enumerate(xs):
            b, s, _ = x.shape
            h = _layer_norm(x, w["ln_1/scale"][p], w["ln_1/bias"][p])
            q = h @ w["attn/q_proj/kernel"][p].to(dt)
            shape = (b, s, q.shape[-1] // cfg.head_dim, cfg.head_dim)
            k = (h @ w["attn/k_proj/kernel"][p].to(dt)).reshape(shape)
            v = (h @ w["attn/v_proj/kernel"][p].to(dt)).reshape(shape)
            a = causal_attention(q.reshape(shape), k, v)
            parts.append(a.reshape(b, s, -1)
                         @ w["attn/o_proj/kernel"][p].to(dt))
        return [x + y for x, y in zip(xs, self._allreduce(parts))]

    def _gather_layer(self, i: int, names) -> Dict[str, tuple]:
        return {n: self._gather(f"layers_{i}/{n}") for n in names}

    _ATTN_LEAVES = ("ln_1/scale", "ln_1/bias", "attn/q_proj/kernel",
                    "attn/k_proj/kernel", "attn/v_proj/kernel",
                    "attn/o_proj/kernel", "ln_2/scale", "ln_2/bias")

    def _block(self, i: int, *xs):
        dt = self.cfg.dtype
        w = self._gather_layer(i, self._ATTN_LEAVES + (
            "mlp/up_proj/kernel", "mlp/down_proj/kernel"))
        xs = self._attention(w, xs)
        parts = []
        for p, x in enumerate(xs):
            h = _layer_norm(x, w["ln_2/scale"][p], w["ln_2/bias"][p])
            h = F.gelu(h @ w["mlp/up_proj/kernel"][p].to(dt),
                       approximate="tanh")
            parts.append(h @ w["mlp/down_proj/kernel"][p].to(dt))
        return tuple(x + y for x, y in zip(xs, self._allreduce(parts)))

    def _layer(self, i: int, xs) -> Tuple[tuple, Optional[torch.Tensor]]:
        """Layer ``i`` on every position (recomputed in the backward under
        remat): the new hidden states and the layer's auxiliary loss (None:
        the dense GPT has none)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                self._block, i, *xs,
                use_reentrant=self._remat_reentrant), None
        return self._block(i, *xs), None

    def _split_batch(self, tokens: torch.Tensor) -> List[torch.Tensor]:
        b = tokens.shape[0]
        if b % self.batch_shards:
            axes = " x ".join(self._BATCH_AXES)
            raise ValueError(f"batch {b} does not split over "
                             f"{self.batch_shards} {axes} shards")
        n = b // self.batch_shards
        return [tokens[i * n:(i + 1) * n].to(self.devices[p])
                for p, i in enumerate(self._batch_index)]

    def forward_hidden_aux(self, tokens
                           ) -> Tuple[List[torch.Tensor],
                                      Optional[torch.Tensor]]:
        """Final-norm hidden states, one ``[B / batch shards, S, D]``
        tensor per mesh position (its batch shard), and the layers' summed
        auxiliary loss on the first position's device (None if no layer
        has one)."""
        cfg, dt = self.cfg, self.cfg.dtype
        toks = self._split_batch(tokens)
        s = tokens.shape[1]
        wte, wpe = self._gather("wte/embedding"), self._gather("wpe/embedding")
        parts = []
        for p, tok in enumerate(toks):
            table = wte[p].to(dt)
            if self.tp > 1:
                vloc = table.shape[0]
                local = tok - self._tensor_index[p] * vloc
                mask = (local >= 0) & (local < vloc)
                emb = table[local.clamp(0, vloc - 1)]
                parts.append(torch.where(mask[..., None], emb,
                                         torch.zeros((), dtype=dt,
                                                     device=emb.device)))
            else:
                parts.append(table[tok])
        xs = [x + pe.to(dt)[:s][None, :, :]
              for x, pe in zip(self._allreduce(parts), wpe)]
        aux_total = None
        for i in range(cfg.n_layers):
            xs, aux = self._layer(i, xs)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        ln_s, ln_b = self._gather("ln_f/scale"), self._gather("ln_f/bias")
        return ([_layer_norm(x, a, b) for x, a, b in zip(xs, ln_s, ln_b)],
                aux_total)

    def forward_hidden(self, tokens) -> List[torch.Tensor]:
        """Final-norm hidden states, one ``[B / batch shards, S, D]``
        tensor per mesh position (its batch shard)."""
        return self.forward_hidden_aux(tokens)[0]

    def cross_entropy(self, hs: List[torch.Tensor], targets) -> torch.Tensor:
        """Mean next-token cross entropy over the whole batch of each
        position's final-norm hidden states, on the first position's
        device; the lm head vocab-parallel over the tensor axis in
        ``max(1, xent_chunks)`` chunks a shard."""
        tgts = self._split_batch(targets)
        heads = self._gather("lm_head/kernel")
        d = self.cfg.d_model
        nll = []
        for group in self._groups:
            nll.append(vocab_parallel_nll(
                [hs[p].reshape(-1, d) for p in group],
                [heads[p] for p in group],
                tgts[group[0]].reshape(-1),
                max(1, self.cfg.xent_chunks)).to(self.devices[0]))
        return torch.cat(nll).mean()

    def loss(self, tokens, targets) -> torch.Tensor:
        """Mean next-token cross entropy over the whole batch (see
        :meth:`cross_entropy`)."""
        return self.cross_entropy(self.forward_hidden(tokens), targets)

    # ------------------------------------------------------- state trees

    def _leaf(self, path: str, pieces) -> ShardedTensor:
        return self.layouts[path].like([t.detach() for t in pieces])

    def state_tree(self, optimizer: Optional[torch.optim.Optimizer] = None
                   ) -> Dict[str, Any]:
        """``{"params": tree}`` in the reference's structure, each leaf a
        ``ShardedTensor`` over the live parameter pieces; with a
        ``optim.TransformationOptimizer``, ``"opt"``: its ``count`` (a 0-d
        tensor) and its ``mu`` and ``nu`` as sharded leaves of the
        parameters' layouts (the reference's ``tx.init(params)`` inherits
        the params' shardings)."""
        params: Dict[str, Any] = {}
        for path in self.paths:
            _tree_set(params, path, self._leaf(path, self.pieces(path)))
        out: Dict[str, Any] = {"params": params}
        if optimizer is not None:
            mu: Dict[str, Any] = {}
            nu: Dict[str, Any] = {}
            for path in self.paths:
                states = [optimizer.state[p] for p in self.pieces(path)]
                _tree_set(mu, path, self._leaf(path, [s["mu"]
                                                      for s in states]))
                _tree_set(nu, path, self._leaf(path, [s["nu"]
                                                      for s in states]))
            first = optimizer.state[self.pieces(self.paths[0])[0]]
            out["opt"] = {"count": first["count"].detach(), "mu": mu,
                          "nu": nu}
        return out

    def grad_tree(self) -> Dict[str, Any]:
        """The parameters' gradients, as ``ShardedTensor`` leaves."""
        out: Dict[str, Any] = {}
        for path in self.paths:
            _tree_set(out, path, self._leaf(
                path, [p.grad for p in self.pieces(path)]))
        return out

    @torch.no_grad()
    def load_state_tree(self, state: Dict[str, Any],
                        optimizer: Optional[torch.optim.Optimizer] = None
                        ) -> None:
        """Copy a :meth:`state_tree` (healed ``ShardedTensor`` leaves of
        this layout) into the live parameters and the optimizer's state, in
        place."""

        def copy(dst: List[torch.Tensor], path: str,
                 src: ShardedTensor) -> None:
            if src.bounds != self.layouts[path].bounds:
                raise ValueError(f"{path}: pieces {src.bounds}, this layout "
                                 f"holds {self.layouts[path].bounds}")
            for d, piece in zip(dst, src.pieces):
                d.copy_(piece)

        for path in self.paths:
            copy(self.pieces(path), path, _tree_get(state["params"], path))
        if optimizer is None:
            return
        opt = state["opt"]
        for path in self.paths:
            states = [optimizer.state[p] for p in self.pieces(path)]
            copy([s["mu"] for s in states], path, _tree_get(opt["mu"], path))
            copy([s["nu"] for s in states], path, _tree_get(opt["nu"], path))
            for s_ in states:
                s_["count"].copy_(opt["count"])
