"""Driver entry points of the port: a forward on the flagship model and a
multi-position dry run (twin of the repo root's ``__graft_entry__.py``).

``entry()`` returns ``(fn, (params, tokens))``: ``fn(params, tokens)`` is
the "125m" GPT's forward (logits) through ``torch.func.functional_call``
over :class:`~torchft_tpu_torch.models.GPT`, ``params`` its state and
``tokens`` drawn as the reference draws them.

``dryrun_multichip(n)`` runs the reference's segments over an
n-position :class:`~torchft_tpu_torch.parallel.Mesh` (virtual: the one
device repeats; on the card unless ``device="cpu"``) and holds each
against its unsharded counterpart in the port:

1. one dp x fsdp x tp step of ``ShardedGPT`` at "tiny" (the reference's
   factorisation of n), and the vocab-parallel cross entropy, whose
   gradient stays sharded over ``tensor``;
2. the GPT's loss through the flash ring over a ``seq`` axis of n;
3. the expert-parallel MoE block over an ``expert`` axis of n, and one
   step of the MoE transformer over ``tensor`` x ``expert``;
4. GPipe, 5. 1F1B and 6. interleaved 1F1B over a ``stage`` axis of n;
7. the fault-tolerance loop (:func:`_dryrun_ft_loop`): two trainer groups
   of 2 ranks, a spare, an observer, a kill and a sharded heal.

Where the card's flash kernels need it the shapes differ from the
reference's: a ring shard and the MoE transformer's sequence are 64 tokens
(the kernels take S a multiple of 64; the reference trims "tiny"'s 128 to
n shards of 16), and the MoE transformer has 2 heads of 16 (the kernels
take head_dim 16 to 128; the reference's are 4 heads of 8). It prints the
reference's summary line, ending in ``OK``, and returns the segments'
figures and each segment's flash launches.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip", "DRYRUN_TOL"]

# each segment's tolerance against its unsharded counterpart, the port's
# own twins' (tests/test_torch_*.py named beside each)
DRYRUN_TOL = {
    # test_torch_sharded_gpt, bf16 activations: loss absolute, gradients
    # relative norm of the difference
    "step_loss": 2e-3, "step_grad": 2e-2,
    # test_torch_xent_parallel: loss atol = rtol, gradients atol / rtol
    "vp_loss": 1e-6, "vp_grad": (1e-6, 1e-5),
    # test_torch_models' ring against local attention: loss rtol,
    # gradients relative norm
    "ring_loss": 5e-3, "ring_grad": 5e-2,
    # test_torch_moe_sharded: the block's y (atol, rtol) and aux rtol; the
    # model's bf16 loss (rtol, atol)
    "moe_y": (1e-5, 1e-4), "moe_aux": 1e-5, "moe_loss": (1e-3, 3e-3),
    # test_torch_pipeline: outputs atol = rtol; 1F1B loss rtol and
    # gradients (rtol, atol)
    "pp_out": 1e-5, "pp_loss": 1e-5, "pp_grad": (1e-4, 1e-6),
}


def entry(device: "Optional[str | torch.device]" = None):
    """(fn, (params, tokens)): the "125m" GPT's forward on the card (or
    ``device``): ``params`` the model's state (name -> tensor), ``tokens``
    ``np.random.default_rng(0).integers(0, vocab, (4, max_seq_len))`` as
    int32, and ``fn(params, tokens)`` the logits, through
    ``torch.func.functional_call`` over the GPT."""
    from torchft_tpu_torch.models import CONFIGS, GPT
    from torchft_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = CONFIGS["125m"]
    model = GPT(cfg, device=device, seed=0)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    tokens = torch.tensor(
        rng.integers(0, cfg.vocab_size, (4, cfg.max_seq_len)),
        dtype=torch.int32, device=device)

    def fn(params, tokens):
        return torch.func.functional_call(model, params, (tokens,))

    return fn, (params, tokens)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _close(got, want, atol: float, rtol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol |want| elementwise; return
    the max abs difference."""
    got = torch.as_tensor(got).detach().double().cpu()
    want = torch.as_tensor(want).detach().double().cpu()
    err = (got - want).abs()
    _require(bool(torch.isfinite(got).all())
             and bool((err <= atol + rtol * want.abs()).all()),
             f"{what}: max abs difference {float(err.max()):.3e} over "
             f"atol {atol} + rtol {rtol}")
    return float(err.max())


class _Launches:
    """Each segment's flash launches (the counters see CUDA launches
    only)."""

    def __init__(self) -> None:
        from torchft_tpu_torch.ops import flash

        self._flash = flash
        self.by_segment: Dict[str, Dict[str, int]] = {}
        self._last = dict(flash.LAUNCHES)

    def mark(self, segment: str) -> None:
        now = dict(self._flash.LAUNCHES)
        self.by_segment[segment] = {k: now[k] - self._last.get(k, 0)
                                    for k in now}
        self._last = now


def _factor(n: int):
    """The reference's dp x fsdp x tp factorisation of n: tensor 2 if it
    divides n, then data 2 if it divides the rest, fsdp the rest."""
    tensor = 2 if n % 2 == 0 else 1
    rest = n // tensor
    data = 2 if rest % 2 == 0 else 1
    return data, rest // data, tensor


def _step_segment(n: int, dev, rng) -> Dict[str, Any]:
    """1. One dp x fsdp x tp step of ShardedGPT at "tiny" against the
    unsharded GPT: loss and every gradient, then an AdamW step on the
    pieces."""
    from torchft_tpu_torch.models import (
        CONFIGS,
        GPT,
        ShardedGPT,
        gpt_param_tree,
    )
    from torchft_tpu_torch.models.transformer import _tree_get
    from torchft_tpu_torch.optim import TransformationOptimizer, adamw
    from torchft_tpu_torch.parallel import ft_mesh

    cfg = CONFIGS["tiny"]
    data, fsdp, tensor = _factor(n)
    mesh = ft_mesh({"data": data, "fsdp": fsdp, "tensor": tensor},
                   devices=[dev] * n)
    dense = GPT(cfg, device=dev, seed=0)
    model = ShardedGPT(cfg, mesh, params=gpt_param_tree(dense))
    split = data * fsdp
    batch = split * math.ceil(max(2, 2 * data) / split)
    tok = torch.tensor(rng.integers(0, cfg.vocab_size,
                                    (batch, cfg.max_seq_len)), device=dev)
    tgt = torch.roll(tok, -1, dims=1)
    want = dense.loss(tok, tgt)
    want.backward()
    loss = model.loss(tok, tgt)
    loss.backward()
    _require(abs(loss.item() - want.item()) <= DRYRUN_TOL["step_loss"],
             f"sharded step loss {loss.item()} against {want.item()}")
    grads = model.grad_tree()
    worst = 0.0
    for name, p in dense.named_parameters():
        rel = _rel(_tree_get(grads, name.replace(".", "/")).full(), p.grad)
        _require(rel <= DRYRUN_TOL["step_grad"],
                 f"sharded step gradient {name}: relative norm {rel:.3e}")
        worst = max(worst, rel)
    opt = TransformationOptimizer(model.parameters(), adamw(1e-3))
    opt.step()
    _require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
             "non-finite parameters after the sharded AdamW step")
    return {"axes": (data, fsdp, tensor), "loss": loss.item(),
            "grad_rel": worst}


def _vocab_segment(n: int, dev, rng) -> Dict[str, Any]:
    """1b. The vocab-parallel cross entropy over the largest tensor axis
    that splits "tiny"'s vocab, against the dense one; the head's gradient
    comes back as pieces of its shard's shape."""
    from torchft_tpu_torch.models import CONFIGS
    from torchft_tpu_torch.ops.xent import make_vocab_parallel_cross_entropy
    from torchft_tpu_torch.parallel import (
        NamedSharding,
        PartitionSpec,
        ShardedTensor,
        ft_mesh,
    )

    cfg = CONFIGS["tiny"]
    d, v = cfg.d_model, cfg.vocab_size
    world = max(k for k in range(1, n + 1) if v % k == 0)
    mesh = ft_mesh({"tensor": world}, devices=[dev] * world)
    h = torch.tensor(rng.standard_normal((8, d)), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.standard_normal((d, v)) * 0.1, dtype=torch.float32,
                     device=dev)
    t = torch.tensor(rng.integers(0, v, (8,)), device=dev)
    head = ShardedTensor.from_full(
        w, NamedSharding(mesh, PartitionSpec(None, "tensor")))
    for p in head.pieces:
        p.requires_grad_(True)
    hs = h.clone().requires_grad_(True)
    loss = make_vocab_parallel_cross_entropy(mesh, "tensor")(hs, head, t)
    loss.backward()
    hd, wd = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = torch.nn.functional.cross_entropy(hd @ wd, t)
    want.backward()
    tol = DRYRUN_TOL["vp_loss"]
    _close(loss, want, tol, tol, "vocab-parallel CE loss")
    atol, rtol = DRYRUN_TOL["vp_grad"]
    _close(hs.grad, hd.grad, atol, rtol, "vocab-parallel CE dh")
    for p, b in zip(head.pieces, head.bounds):
        _require(p.grad is not None and p.grad.shape == p.shape
                 == (d, v // world),
                 "the vocab-parallel CE gradient lost its vocab sharding")
        _close(p.grad, wd.grad[:, b[1][0]:b[1][1]], atol, rtol,
               "vocab-parallel CE dw")
    return {"world": world, "loss": loss.item()}


def _ring_segment(n: int, dev, rng) -> Dict[str, Any]:
    """2. The GPT's loss and gradients through the flash ring over a
    ``seq`` axis of n shards of 64 tokens, against local attention."""
    from torchft_tpu_torch.models import CONFIGS, GPT, loss_fn
    from torchft_tpu_torch.parallel import ft_mesh, make_ring_attention

    cfg = dataclasses.replace(CONFIGS["tiny"], max_seq_len=64 * n)
    model = GPT(cfg, device=dev, seed=1)
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, (2, cfg.max_seq_len)),
                       device=dev)
    tgt = torch.roll(tok, -1, dims=1)
    ring = make_ring_attention(ft_mesh({"seq": n}, devices=[dev] * n),
                               "seq", causal=True, block_impl="flash")
    loss = loss_fn(cfg, model, tok, tgt, attn_fn=ring)
    loss.backward()
    g_ring = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    want = loss_fn(cfg, model, tok, tgt)
    want.backward()
    _close(loss, want, 0.0, DRYRUN_TOL["ring_loss"], "ring loss")
    worst = 0.0
    for k, p in model.named_parameters():
        rel = _rel(g_ring[k], p.grad)
        _require(rel <= DRYRUN_TOL["ring_grad"],
                 f"ring gradient {k}: relative norm {rel:.3e}")
        worst = max(worst, rel)
    return {"seq": cfg.max_seq_len, "loss": loss.item(), "grad_rel": worst}


def _moe_segment(n: int, dev, rng) -> Dict[str, Any]:
    """3. The expert-parallel MoE block over an ``expert`` axis of n
    against the unsharded block; then one step of the MoE transformer over
    ``tensor`` x ``expert`` against the width-1 model, and SGD on the
    pieces."""
    from torchft_tpu_torch.models import (
        MoETransformer,
        MoETransformerConfig,
        ShardedMoETransformer,
        gpt_param_tree,
    )
    from torchft_tpu_torch.models.transformer import _tree_get
    from torchft_tpu_torch.parallel import (
        MoEConfig,
        ft_mesh,
        init_moe_params,
        moe_forward,
        moe_forward_sharded,
        moe_rules,
        shard_pytree,
    )

    out: Dict[str, Any] = {}
    mesh = ft_mesh({"expert": n}, devices=[dev] * n)
    cfg = MoEConfig(d_model=32, d_ff=64, num_experts=n)
    params = init_moe_params(cfg, seed=2, device=dev)
    sharded = shard_pytree(params, mesh, tp_rules=moe_rules(),
                           fsdp_axis=None, tensor_axis="expert")
    seq = 16 if 32 % n == 0 else 8 * n  # the tokens split over n shards
    x = torch.tensor(rng.standard_normal((2, seq, 32)), dtype=torch.float32,
                     device=dev)
    y, aux = moe_forward_sharded(cfg, sharded, x)
    y_ref, aux_ref = moe_forward(cfg, params, x)
    atol, rtol = DRYRUN_TOL["moe_y"]
    _close(y, y_ref, atol, rtol, "expert-parallel MoE y")
    _close(aux, aux_ref, 0.0, DRYRUN_TOL["moe_aux"], "expert-parallel MoE aux")
    out["ep_aux"] = float(aux)

    ep = 4 if n % 4 == 0 else n
    tp = n // ep
    mcfg = MoETransformerConfig(vocab_size=128, d_model=32, n_layers=2,
                                n_heads=2, d_ff=64, max_seq_len=64,
                                num_experts=ep, remat=False)
    dense = MoETransformer(mcfg, device=dev, seed=3)
    model = ShardedMoETransformer(
        mcfg, ft_mesh({"tensor": tp, "expert": ep}, devices=[dev] * n),
        params=gpt_param_tree(dense))
    tok = torch.tensor(rng.integers(0, mcfg.vocab_size,
                                    (max(2, ep), mcfg.max_seq_len)),
                       device=dev)
    tgt = torch.roll(tok, -1, dims=1)
    want = dense.loss(tok, tgt)
    want.backward()
    loss = model.loss(tok, tgt)
    loss.backward()
    rtol, atol = DRYRUN_TOL["moe_loss"]
    _close(loss, want, atol, rtol, "MoE transformer loss")
    # in bf16 the tensor axis's partial sums round apart from the dense
    # products and flip top-2 choices, so the gradients are held finite
    # (the twin holds bf16 losses only; in f32 it holds them within 5e-5)
    grads = model.grad_tree()
    for name, _ in dense.named_parameters():
        g = _tree_get(grads, name.replace(".", "/")).full()
        _require(bool(torch.isfinite(g).all()),
                 f"MoE transformer gradient {name} is not finite")
    torch.optim.SGD(model.parameters(), lr=1e-2).step()
    _require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
             "non-finite parameters after the MoE transformer's step")
    out.update(moe_axes=(tp, ep), moe_loss=loss.item(),
               moe_loss_diff=abs(loss.item() - want.item()))
    return out


def _stage_fn(p, h):
    return torch.relu(h @ p["w"])


def _mse(h, y):
    return torch.mean((h - y) ** 2)


def _pipeline_segments(n: int, dev, rng) -> Dict[str, Any]:
    """4. GPipe, 5. 1F1B and 6. interleaved 1F1B (2 chunks a position)
    over a ``stage`` axis of n, each against the stages run in sequence:
    GPipe's output, and the 1F1B runners' loss and gradients against
    autograd through the sequence."""
    from torchft_tpu_torch.parallel import (
        ft_mesh,
        make_pipeline,
        make_pipeline_1f1b,
        make_pipeline_interleaved_1f1b,
        merge_microbatches,
        split_microbatches,
        stack_interleaved_params,
        stack_stage_params,
    )

    def weights(k: int):
        return [{"w": torch.tensor(rng.standard_normal((16, 16)) * 0.3,
                                   dtype=torch.float32, device=dev)}
                for _ in range(k)]

    mesh = ft_mesh({"stage": n}, devices=[dev] * n)
    stages = weights(n)
    x = torch.tensor(rng.standard_normal((8, 16)), dtype=torch.float32,
                     device=dev)
    xm = split_microbatches(x, 4)
    out = merge_microbatches(make_pipeline(mesh, _stage_fn)(
        stack_stage_params(stages), xm))
    h = x
    for p in stages:
        h = _stage_fn(p, h)
    tol = DRYRUN_TOL["pp_out"]
    _close(out, h, tol, tol, "GPipe output")
    ym = split_microbatches(torch.tensor(rng.standard_normal((8, 16)),
                                         dtype=torch.float32, device=dev), 4)
    rtol, atol = DRYRUN_TOL["pp_grad"]

    def check(run, stacked, virtual, order, what):
        loss, grads = run(stacked, xm, ym)
        leaves = [p["w"].clone().requires_grad_(True) for p in virtual]
        total = 0.0
        for k in range(4):
            hk = xm[k]
            for v in order:
                hk = _stage_fn({"w": leaves[v]}, hk)
            total = total + _mse(hk, ym[k])
        total = total / 4
        total.backward()
        _close(loss, total, 0.0, DRYRUN_TOL["pp_loss"], f"{what} loss")
        want = stack_interleaved_params(
            [{"w": p.grad} for p in leaves], n, len(virtual) // n)
        _close(grads["w"], want["w"], atol, rtol, f"{what} gradients")
        gnorm = float(grads["w"].double().pow(2).sum())
        _require(math.isfinite(gnorm) and gnorm > 0,
                 f"{what} gradients degenerate")
        return float(loss)

    loss_1f1b = check(make_pipeline_1f1b(mesh, _stage_fn, _mse, 4),
                      stack_stage_params(stages), stages, range(n), "1F1B")
    virt = weights(2 * n)
    loss_iv = check(
        make_pipeline_interleaved_1f1b(mesh, _stage_fn, _mse, 4, 2),
        stack_interleaved_params(virt, n, 2), virt, range(2 * n),
        "interleaved 1F1B")
    return {"pp_norm": float(out.sum()), "pp1f1b_loss": loss_1f1b,
            "pp_iv_loss": loss_iv}


def dryrun_multichip(n_devices: int,
                     device: "Optional[str | torch.device]" = None
                     ) -> Dict[str, Any]:
    """The reference's dry run over an n-position virtual mesh of the card
    (or ``device``): every segment of the module docstring, each held
    against its unsharded counterpart within ``DRYRUN_TOL``; raises on the
    first miss. Prints the summary line (``... ft[...] OK``) and returns
    it (``summary``) with each segment's figures (``segments``), flash
    launches (``launches``) and seconds (``seconds``)."""
    from torchft_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n = int(n_devices)
    rng = np.random.default_rng(0)
    launches = _Launches()
    segments: Dict[str, Dict[str, Any]] = {}
    seconds: Dict[str, float] = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    # the f32 segments hold to 1e-6: their products stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, fn in (("step", _step_segment), ("vocab", _vocab_segment),
                         ("ring", _ring_segment), ("moe", _moe_segment),
                         ("pipeline", _pipeline_segments)):
            t0 = time.perf_counter()
            segments[name] = fn(n, dev, rng)
            seconds[name] = time.perf_counter() - t0
            launches.mark(name)
        t0 = time.perf_counter()
        ft = _dryrun_ft_loop(n, dev)
        seconds["ft"] = time.perf_counter() - t0
        launches.mark("ft")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    data, fsdp, tensor = segments["step"]["axes"]
    summary = (
        f"dryrun_multichip({n}): dp={data} fsdp={fsdp} tp={tensor} "
        f"loss={segments['step']['loss']:.4f} "
        f"vp_ce={segments['vocab']['loss']:.4f} "
        f"sp_loss={segments['ring']['loss']:.4f} "
        f"ep_aux={segments['moe']['ep_aux']:.4f} "
        f"pp_norm={segments['pipeline']['pp_norm']:.3f} "
        f"pp1f1b_loss={segments['pipeline']['pp1f1b_loss']:.4f} "
        f"ft[{ft['trace']}] OK")
    print(summary, flush=True)
    segments["ft"] = ft
    return {"summary": summary, "segments": segments,
            "launches": launches.by_segment, "seconds": seconds}


def _dryrun_ft_loop(n_devices: int,
                    device: "Optional[str | torch.device]" = None
                    ) -> Dict[str, Any]:
    """The reference's FT segment on the port's Manager, ``TcpCommContext``
    and ``CheckpointServer``, at its topology over virtual positions of
    ``device``:

    * 2 trainer replica groups x ``ranks_per_group`` ranks (2 from n = 4),
      each rank an fsdp sub-mesh of ``n // (2 * ranks)`` positions with
      rank-DISTINCT state. A whole-group kill relaunches both ranks
      poisoned, and each heals rank to rank through the manager's per-rank
      checkpoint metadata and its template (``CheckpointServer(
      template_fn=...)``): from n = 4 the healed leaf must come back as a
      ``ShardedTensor`` on the rank's fsdp sharding;
    * one SPARE group under ``WorldSizeMode.FIXED_WITH_SPARES``
      (``min_replica_size=2``): parked (zero gradients) while both
      trainers are healthy, promoted into the committing cohort in the
      dead window, parked again after the heal;
    * one OBSERVER (``data_plane=False``): joins every quorum and commit
      barrier, never participates.

    The trajectory oracle runs per rank across the three data-plane
    groups (the reference's rtol 1e-5, atol 1e-6). Returns the trace the
    summary line carries (``trace``) and its counts."""
    from torchft_tpu_torch.checkpointing import CheckpointServer
    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.comm.transport import TcpCommContext
    from torchft_tpu_torch.control import Lighthouse
    from torchft_tpu_torch.manager import Manager, WorldSizeMode
    from torchft_tpu_torch.parallel import (
        PartitionSpec,
        ShardedTensor,
        ft_mesh,
        shard_pytree,
    )
    from torchft_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    ranks_per_group = 2 if n_devices >= 4 else 1
    per_rank = max(1, n_devices // (2 * ranks_per_group))
    n_groups = 3  # groups 0, 1 train; group 2 is the spare
    target_commits, kill_at = 5, 3
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=300,
                            heartbeat_timeout_ms=1000)
    stop = threading.Event()
    lock = threading.Lock()
    keys = [(g, r) for g in range(n_groups) for r in range(ranks_per_group)]
    commits = {k: 0 for k in keys}
    history: Dict[Any, Dict[int, np.ndarray]] = {k: {} for k in keys}
    counts = {"heals": 0, "parked": 0, "promoted": 0, "obs_rounds": 0,
              "obs_world": 0}
    obs_participated = [False]
    errors: list = []

    def rank_main(group, rank, store_addr, restarted, killed) -> None:
        mesh = ft_mesh({"fsdp": per_rank}, devices=[dev] * per_rank)
        seed = 99.0 if restarted else 1.0  # poison: only a heal fixes it
        # dim 0 splits over fsdp at any n, so the sharded heal path runs;
        # rank-distinct values: a cross-rank heal mix-up would diverge
        holder = {"params": shard_pytree(
            {"w": torch.full((4 * per_rank, 8), seed + 100.0 * rank,
                             device=dev)},
            mesh, tp_rules=None, fsdp_axis="fsdp")}

        def state_dict():
            return {"params": holder["params"]}

        def load_state_dict(sd):
            leaf = sd["params"]["w"]
            if per_rank > 1:
                # the heal lands the leaf on OUR fsdp sharding
                _require(isinstance(leaf, ShardedTensor)
                         and tuple(leaf.sharding.spec) in (
                             tuple(PartitionSpec("fsdp", None)),
                             tuple(PartitionSpec(None, "fsdp")))
                         and leaf.sharding == holder["params"]["w"].sharding,
                         f"the heal lost the fsdp sharding: {leaf!r}")
            holder["params"] = sd["params"]

        transport = CheckpointServer(timeout=5.0, template_fn=lambda: {
            "user": state_dict(),
            "torchft": {"step": 0, "batches_committed": 0}})
        target = 10.0 * (rank + 1)  # rank-distinct trajectories

        def grad_step(leaf: ShardedTensor):
            live = [p.detach().requires_grad_(True) for p in leaf.pieces]
            loss = sum(((p - target) ** 2).sum() for p in live) \
                / math.prod(leaf.shape)
            return torch.autograd.grad(loss, live)

        manager = Manager(
            comm=TcpCommContext(timeout=5.0),
            load_state_dict=load_state_dict,
            state_dict=state_dict,
            checkpoint_transport=transport,
            min_replica_size=2,
            world_size_mode=WorldSizeMode.FIXED_WITH_SPARES,
            use_async_quorum=True,
            timeout=10.0, quorum_timeout=10.0, connect_timeout=10.0,
            rank=rank, world_size=ranks_per_group,
            store_addr=store_addr,
            lighthouse_addr=lighthouse.address(),
            replica_id=f"dryrun_ft_{group}_",
            heartbeat_interval=0.05,
        )
        try:
            while not stop.is_set() and not killed.is_set():
                if (group == 1 and rank == 0 and not restarted
                        and manager.current_step() >= kill_at):
                    killed.set()  # a whole-group kill: both ranks go down
                    return
                try:
                    manager.start_quorum()
                    grads = grad_step(holder["params"]["w"])
                    avg = manager.allreduce_arrays(
                        [g.cpu().numpy() for g in grads]).future().result(20)
                    committed = manager.should_commit()
                except (TimeoutError, RuntimeError):
                    continue
                if not committed:
                    time.sleep(0.01)
                    continue
                if manager.did_heal():
                    with lock:
                        counts["heals"] += 1
                if group == 2 and rank == 0:
                    with lock:
                        counts["promoted" if manager.is_participating()
                               else "parked"] += 1
                leaf = holder["params"]["w"]
                holder["params"] = {"w": leaf.like([
                    p - 0.05 * torch.from_numpy(np.asarray(a)).to(p)
                    for p, a in zip(leaf.pieces, avg)])}
                snap = holder["params"]["w"].full("cpu").numpy()
                with lock:
                    history[(group, rank)][manager.current_step()] = snap
                    commits[(group, rank)] += 1
                    if all(c >= target_commits for c in commits.values()):
                        stop.set()
        finally:
            manager.shutdown(wait=False)

    def observer_main() -> None:
        store = StoreServer()
        manager = Manager(
            load_state_dict=lambda sd: None, state_dict=lambda: {},
            min_replica_size=2, use_async_quorum=True,
            timeout=10.0, quorum_timeout=10.0, connect_timeout=10.0,
            rank=0, world_size=1, store_addr=store.addr,
            lighthouse_addr=lighthouse.address(),
            replica_id="dryrun_ft_observer_", heartbeat_interval=0.05,
            data_plane=False)
        try:
            while not stop.is_set():
                try:
                    manager.start_quorum()
                    manager.wait_quorum()
                except (TimeoutError, RuntimeError):
                    continue
                with lock:
                    counts["obs_rounds"] += 1
                    counts["obs_world"] = max(counts["obs_world"],
                                              manager.replica_world_size())
                    if manager.is_participating():
                        obs_participated[0] = True
                time.sleep(0.02)
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    def group_main(group: int) -> None:
        restarted = False
        while not stop.is_set():
            store = StoreServer()
            killed = threading.Event()
            ranks = [threading.Thread(
                target=guarded(rank_main, f"group {group} rank {r}"),
                args=(group, r, store.addr, restarted, killed),
                daemon=True, name=f"dryrun_ft_{group}_{r}")
                for r in range(ranks_per_group)]
            for t in ranks:
                t.start()
            for t in ranks:
                t.join(timeout=150)
            store.shutdown()
            if killed.is_set() and not stop.is_set():
                restarted = True  # the relaunch: poisoned, must heal
                continue
            return

    def guarded(fn, what: str):
        def _run(*args) -> None:
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — surfaced below
                import traceback

                with lock:
                    errors.append(f"{what}:\n{traceback.format_exc()}")
                stop.set()
        return _run

    threads = [threading.Thread(target=guarded(group_main, f"group {g}"),
                                args=(g,), daemon=True,
                                name=f"dryrun_ft_g{g}")
               for g in range(n_groups)]
    threads.append(threading.Thread(target=guarded(observer_main,
                                                   "observer"),
                                    daemon=True, name="dryrun_ft_obs"))
    deadline = time.time() + 150
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(1.0, deadline - time.time()))
    finally:
        stop.set()
        for t in threads:  # let the loops drain: the snapshots are stable
            t.join(10.0)
        lighthouse.shutdown()
    if errors:
        raise RuntimeError("dryrun FT loop failed:\n" + "\n".join(errors))
    with lock:
        commits_snap = dict(commits)
        history_snap = {k: dict(h) for k, h in history.items()}
        c = dict(counts)
        participated = obs_participated[0]
    for key, done in commits_snap.items():
        _require(done >= target_commits,
                 f"group {key[0]} rank {key[1]} stalled: {commits_snap}")
    _require(c["heals"] >= ranks_per_group,
             f"every rank of the killed group must heal: {c['heals']}")
    _require(c["parked"] >= 1, "the spare never parked "
             "(FIXED_WITH_SPARES inert)")
    _require(c["promoted"] >= 1, "the spare never promoted into the cohort "
             "during the dead window")
    _require(c["obs_rounds"] >= 1, "the observer never completed a quorum")
    _require(c["obs_world"] >= 4, f"the observer saw at most "
             f"{c['obs_world']} replicas (3 groups and itself expected)")
    _require(not participated, "an observer must never participate")
    common_total = 0
    for r in range(ranks_per_group):
        common = sorted(set.intersection(
            *(set(history_snap[(g, r)]) for g in range(n_groups))))
        _require(any(s > kill_at + 1 for s in common),
                 f"rank {r}: no common steps after the kill and heal: "
                 f"{common}")
        for s in common:
            for g in (1, 2):
                np.testing.assert_allclose(
                    history_snap[(0, r)][s], history_snap[(g, r)][s],
                    rtol=1e-5, atol=1e-6,
                    err_msg=f"trajectory divergence g{g} r{r} step {s}")
        common_total += len(common)
    trace = (f"groups=3x{ranks_per_group}rx{per_rank}dev(incl spare) "
             f"observer=1 "
             f"commits={'/'.join(str(commits_snap[(g, 0)]) for g in range(3))}"
             f" heals={c['heals']} parked={c['parked']} "
             f"promoted={c['promoted']} obs_rounds={c['obs_rounds']} "
             f"common_steps={common_total}")
    return {"trace": trace, "ranks_per_group": ranks_per_group,
            "per_rank": per_rank, "commits": commits_snap,
            "common_steps": common_total, "observer_participated":
            participated, **c}
