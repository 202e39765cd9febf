"""ResNet-18 for CIFAR-10 (BASELINE config #2: the reference's train_ddp.py
example family).

Twin of ``torchft_tpu/models/resnet.py`` (flax.linen) as an ``nn.Module``:
the CIFAR stem (a 3x3 conv, no max-pool), eight residual blocks (64, 64,
128, 128, 256, 256, 512, 512 channels, stride 2 entering 128, 256 and 512,
a 1x1 projection where the shape changes), a global mean and a dense
layer. The convolutions are ``nn.Conv2d`` without bias (the reference's
are XLA convolutions, no Pallas kernel). Inputs are NCHW (the reference's
are NHWC), in f32.

BatchNorm is flax's, not ``nn.BatchNorm2d``'s: the batch statistics in
f32 with the biased variance ``E[x^2] - E[x]^2`` (clipped at 0), epsilon
1e-5, and the running averages ``0.99 * running + 0.01 * batch`` (flax's
``momentum=0.99``; torch's 0.01 with the unbiased variance is another
update). ``train`` (default: the module's mode) picks the batch statistics
and updates the running ones, as flax's ``train=True`` with
``mutable=["batch_stats"]``.

Submodules carry flax's names (``Conv_0``, ``BatchNorm_0``,
``ResidualBlock_i/Conv_j``, ``Dense_0``); :func:`resnet_state_tree` gives
the reference's variables tree (``params`` and ``batch_stats``, its
layouts: HWIO kernels, ``Dense_0/kernel`` ``[512, classes]``), and
:func:`resnet_from_jax` maps such a tree onto this module's state dict.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from torchft_tpu_torch.utils.device import resolve_device

__all__ = ["BatchNorm", "ResNet18", "ResidualBlock", "create_resnet18",
           "load_resnet_state_tree", "resnet_from_jax", "resnet_state_tree"]

_STAGES = ((64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
           (512, 2), (512, 1))


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over the channels of NCHW inputs (see the
    module docstring): ``weight``/``bias`` are flax's ``scale``/``bias``,
    ``running_mean``/``running_var`` its ``batch_stats`` ``mean``/``var``."""

    def __init__(self, c: int, momentum: float = 0.99,
                 eps: float = 1e-5) -> None:
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train: bool):
        if train:
            x32 = x.float()
            mean = x32.mean((0, 2, 3))
            var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(c_out)
        self.Conv_1 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(c_out)
        self.project = c_in != c_out or stride != 1
        if self.project:
            # flax's "SAME" 1x1: no padding
            self.Conv_2 = nn.Conv2d(c_in, c_out, 1, stride, 0, bias=False)
            self.BatchNorm_2 = BatchNorm(c_out)

    def forward(self, x, train: bool):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = x
        if self.project:
            residual = self.BatchNorm_2(self.Conv_2(x), train)
        return torch.relu(y + residual)


class ResNet18(nn.Module):
    """NCHW images -> ``[B, num_classes]`` f32 logits."""

    def __init__(self, num_classes: int = 10) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        c_in = 64
        for i, (c, stride) in enumerate(_STAGES):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(c_in, c, stride))
            c_in = c
        self.Dense_0 = nn.Linear(512, num_classes)

    def forward(self, x, train: Optional[bool] = None):
        train = self.training if train is None else train
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        for i in range(len(_STAGES)):
            x = getattr(self, f"ResidualBlock_{i}")(x, train)
        return self.Dense_0(x.mean((2, 3)).float())


def create_resnet18(seed: int, num_classes: int = 10,
                    device: "Optional[str | torch.device]" = None
                    ) -> ResNet18:
    """A ResNet-18 on ``device`` (CUDA by default) with flax's initializers
    drawn from a ``torch.Generator`` seeded with ``seed``: LeCun normal
    kernels (a normal truncated at 2 sigma, variance 1 / fan_in), zero
    biases, unit BatchNorm scales."""
    model = ResNet18(num_classes)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for _, mod in model.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                fan_in = int(np.prod(w.shape[1:]))
                # the standard deviation of N(0, 1) truncated to [-2, 2]
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=gen)
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
    return model.to(resolve_device(device))


def _leaves(model: ResNet18):
    """(state-dict key, tree path, to the reference's layout, back) for
    every parameter and running statistic."""
    ident = (lambda t: t, lambda t: t)
    hwio = (lambda t: t.permute(2, 3, 1, 0), lambda t: t.permute(3, 2, 0, 1))
    dense = (lambda t: t.t(), lambda t: t.t())
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, nn.Conv2d):
            yield f"{name}.weight", f"params/{path}/kernel", *hwio
        elif isinstance(mod, BatchNorm):
            yield f"{name}.weight", f"params/{path}/scale", *ident
            yield f"{name}.bias", f"params/{path}/bias", *ident
            yield (f"{name}.running_mean", f"batch_stats/{path}/mean",
                   *ident)
            yield f"{name}.running_var", f"batch_stats/{path}/var", *ident
        elif isinstance(mod, nn.Linear):
            yield f"{name}.weight", f"params/{path}/kernel", *dense
            yield f"{name}.bias", f"params/{path}/bias", *ident


def _tree_set(tree: Dict[str, Any], path: str, value: Any) -> None:
    *parents, leaf = path.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def _tree_get(tree: Any, path: str) -> Any:
    for k in path.split("/"):
        tree = tree[k]
    return tree


def resnet_state_tree(model: ResNet18,
                      optimizer: Optional[torch.optim.SGD] = None
                      ) -> Dict[str, Any]:
    """The reference's variables tree of ``model``'s current state:
    ``{"params": ..., "batch_stats": ...}``, each leaf a contiguous copy in
    the reference's layout (what a reference peer's heal carries). With an
    SGD ``optimizer`` whose momentum buffers exist
    (``optim.init_sgd_state``), ``"opt": {"trace": ...}`` too: the buffers
    in the ``params`` tree's paths and layouts (optax's momentum
    ``trace``)."""
    sd = model.state_dict()
    params = dict(model.named_parameters())
    tree: Dict[str, Any] = {}
    for key, path, to_ref, _ in _leaves(model):
        _tree_set(tree, path, to_ref(sd[key].detach()).clone(
            memory_format=torch.contiguous_format))
        if optimizer is not None and key in params:
            buf = optimizer.state[params[key]]["momentum_buffer"]
            _tree_set(tree, "opt/trace/" + path.split("/", 1)[1],
                      to_ref(buf.detach()).clone(
                          memory_format=torch.contiguous_format))
    return tree


@torch.no_grad()
def load_resnet_state_tree(model: ResNet18, tree: Dict[str, Any],
                           optimizer: Optional[torch.optim.SGD] = None
                           ) -> None:
    """Copy a :func:`resnet_state_tree` (parameters, running statistics
    and, with ``optimizer``, its momentum buffers) into ``model`` and the
    optimizer in place."""
    model.load_state_dict(resnet_from_jax(tree))
    if optimizer is None:
        return
    params = dict(model.named_parameters())
    for key, path, _, from_ref in _leaves(model):
        if key in params:
            optimizer.state[params[key]]["momentum_buffer"].copy_(from_ref(
                _tree_get(tree, "opt/trace/" + path.split("/", 1)[1])))


def resnet_from_jax(variables: Any,
                    num_classes: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """A state dict for :class:`ResNet18` from a variables tree in the
    reference's structure and layouts (``jax.device_get`` of flax's, or
    :func:`resnet_state_tree`'s): ``params`` and ``batch_stats``. Torch
    tensors are taken on their device; anything else becomes an f32 CPU
    tensor. Load it with ``model.load_state_dict``."""
    if num_classes is None:
        num_classes = int(np.shape(
            variables["params"]["Dense_0"]["bias"])[0])
    out: Dict[str, torch.Tensor] = {}
    for key, path, _, from_ref in _leaves(ResNet18(num_classes)):
        node = _tree_get(variables, path)
        t = node if isinstance(node, torch.Tensor) else torch.from_numpy(
            np.array(node, dtype=np.float32))
        out[key] = from_ref(t).contiguous()
    return out
