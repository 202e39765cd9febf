"""Toy models for examples and tests (BASELINE config #1: the train_ddp.py
``Linear(2, 3)``-class model).

Twin of ``torchft_tpu/models/mlp.py`` as plain functions on tensors: the
reference's tree (``dense_i/{kernel, bias}``), ``kernel`` ``[in, out]``
drawn N(0, 0.1^2), zero biases. The draws come from an explicit
``torch.Generator`` (on the CPU, one layer after another), and the
tensors land on ``device`` (CUDA unless asked for the CPU).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from torchft_tpu_torch.utils.device import resolve_device

__all__ = ["init_linear", "linear_forward", "init_mlp", "mlp_forward"]


def init_linear(gen: torch.Generator, in_dim: int = 2, out_dim: int = 3,
                device: "Optional[str | torch.device]" = None
                ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        "kernel": (torch.randn((in_dim, out_dim), generator=gen)
                   * 0.1).to(dev),
        "bias": torch.zeros((out_dim,), device=dev),
    }


def linear_forward(params: Dict[str, torch.Tensor], x: torch.Tensor
                   ) -> torch.Tensor:
    return x @ params["kernel"] + params["bias"]


def init_mlp(gen: torch.Generator, dims: Sequence[int],
             device: "Optional[str | torch.device]" = None
             ) -> Dict[str, Dict[str, torch.Tensor]]:
    return {f"dense_{i}": init_linear(gen, d_in, d_out, device)
            for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:]))}


def mlp_forward(params: Dict[str, Dict[str, torch.Tensor]],
                x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        x = linear_forward(params[f"dense_{i}"], x)
        if i < n - 1:
            x = torch.relu(x)
    return x
