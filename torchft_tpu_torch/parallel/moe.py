"""Expert parallelism: a capacity-based top-2 MoE feed-forward block.

Twin of ``torchft_tpu/parallel/moe.py``: the GShard formulation. Routing
builds dense ``[tokens, experts, capacity]`` dispatch and combine tensors
and four einsums move tokens to their experts and back, with static shapes
(the capacity bounds the routing). Tokens past an expert's capacity are
dropped (they pass through the residual). The routing runs in f32, the
expert products in ``cfg.dtype``; the GELU is the tanh approximation
(``jax.nn.gelu``'s default). The reference shards the expert weights on an
``expert`` mesh axis (``moe_rules``); here the experts live on one device,
the reference's expert axis of width 1.

    params = init_moe_params(cfg, seed=0)
    y, aux_loss = moe_forward(cfg, params, x)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torchft_tpu_torch.utils.device import resolve_device

__all__ = ["MoEConfig", "init_moe_params", "moe_forward"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    capacity_factor: float = 1.25
    dtype: Optional[torch.dtype] = None  # default: x.dtype


def init_moe_params(cfg: MoEConfig, seed: int = 0, device=None
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """f32 parameters in the reference's layout and scales: the router
    ``gate/kernel`` [D, E] and the experts' ``up`` [E, D, F] and ``down``
    [E, F, D], drawn from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    gate = torch.randn((d, e), generator=gen) / d ** 0.5
    up = torch.randn((e, d, f), generator=gen) / d ** 0.5
    down = torch.randn((e, f, d), generator=gen) / f ** 0.5
    dev = resolve_device(device)
    return {"gate": {"kernel": gate.to(dev)},
            "experts": {"up": up.to(dev), "down": down.to(dev)}}


def _top2_routing(gates: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates [N, E] -> (dispatch [N, E, C] of 0/1, combine [N, E, C], the
    top-1 mask [N, E]). A token's queue position within its expert comes
    from a cumulative sum in the gates' dtype (exact below 2^24 tokens in
    f32), second choices queued after every first choice; ties in the
    argmax take the first expert."""
    n, e = gates.shape
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx1, e).to(gates.dtype)
    gates_wo1 = gates * (1.0 - mask1)
    idx2 = torch.argmax(gates_wo1, dim=-1)
    mask2 = F.one_hot(idx2, e).to(gates.dtype)

    pos1 = torch.cumsum(mask1, dim=0) * mask1 - mask1
    pos2 = (torch.cumsum(mask2, dim=0) + mask1.sum(dim=0, keepdim=True)) \
        * mask2 - mask2
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)

    # renormalized top-2 weights of the kept tokens
    w1 = torch.sum(gates * keep1, dim=-1)
    w2 = torch.sum(gates * keep2, dim=-1)
    denom = torch.clamp(w1 + w2, min=1e-9)
    w1, w2 = w1 / denom, w2 / denom

    cap_iota = torch.arange(capacity, device=gates.device)
    d1 = keep1[..., None] * (pos1[..., None] == cap_iota)
    d2 = keep2[..., None] * (pos2[..., None] == cap_iota)
    dispatch = d1 + d2
    combine = d1 * w1[:, None, None] + d2 * w2[:, None, None]
    return dispatch, combine, mask1


def moe_forward(cfg: MoEConfig, params: Dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], the load-balancing loss, a scalar:
    E * sum over experts of (fraction of tokens routed there first) x
    (mean gate)). The capacity is ``max(1, int(cf * N * 2 / E))``."""
    b, s, d = x.shape
    n = b * s
    dtype = cfg.dtype or x.dtype
    tokens = x.reshape(n, d)

    logits = tokens.float() @ params["gate"]["kernel"]
    gates = torch.softmax(logits, dim=-1)
    capacity = max(1, int(cfg.capacity_factor * n * 2 / cfg.num_experts))
    dispatch, combine, mask1 = _top2_routing(gates, capacity)

    frac_routed = torch.mean(mask1, dim=0)
    mean_gate = torch.mean(gates, dim=0)
    aux = cfg.num_experts * torch.sum(frac_routed * mean_gate)

    up = params["experts"]["up"].to(dtype)
    down = params["experts"]["down"].to(dtype)
    dispatch = dispatch.to(dtype)
    combine = combine.to(dtype)
    tokens = tokens.to(dtype)

    expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, up),
               approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", h, down)
    out = torch.einsum("nec,ecd->nd", combine, expert_out)
    return out.reshape(b, s, d).to(x.dtype), aux
