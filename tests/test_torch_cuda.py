"""The port's CUDA kernels on the card (skipped without a GPU).

The kernels have no CPU mode, so these tests hold them against their plain
PyTorch versions on the card, small shapes in bf16, under
``flash.KERNEL_TOL``: each element within one bf16 ulp of the plain
version's (plus 1e-4), the relative norm of the difference at most 1e-3,
lse within 1e-5. A build of the kernels that rounds P and dS to plain bf16
for its products must fail that check. This file imports no JAX, so it runs
where only torch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import dataclasses
import shutil

import pytest
import torch

from torchft_tpu_torch.models import CONFIGS, GPT
from torchft_tpu_torch.ops import _build, attention, flash

# the GPT's loss with the kernels against the same model on the CPU path,
# whose reference attention rounds P to bf16 before P V
LOSS_TOL = 2e-2
# the kernel's attention against that reference attention, per element
# (|got - want| <= atol + rtol |want|) and in relative norm
REF_ATOL, REF_RTOL, REF_REL_NORM = 1e-3, 2.0 ** -6, 1e-2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _kernels_and_plain(causal, seed=0):
    """[(what, kernel result, plain result)] for all three kernels."""
    b, s, h, d = 2, 256, 4, 64
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = flash.flash_fwd(q, k, v, causal, scale)
    p_out, p_lse = flash.flash_fwd_plain(q, k, v, causal, scale, 128, 128)
    delta = (do.float() * p_out.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = flash.flash_block_attention_bwd(q, k, v, do, p_lse, delta,
                                                 causal)
    pq = flash.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, causal, scale,
                                  128, 128)
    pk, pv = flash.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta, causal,
                                       scale, 128, 128)
    torch.cuda.synchronize()
    return [("out", out, p_out), ("lse", lse, p_lse), ("dq", dq, pq),
            ("dk", dk, pk), ("dv", dv, pv)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain_on_card(causal) -> None:
    _cuda()
    for what, got, want in _kernels_and_plain(causal):
        err = flash.kernel_error(got, want)
        assert err["ok"], (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_tolerance_rejects_plain_bf16_products(causal, tmp_path,
                                               monkeypatch) -> None:
    """Drop the lo term of the hi + lo split (P and dS then enter the
    tensor cores as plain bf16): every bf16 result must fail the check."""
    _cuda()
    src = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, src)
    common = src / "flash_common.cuh"
    text = common.read_text()
    lo_term = "      mma16816(out[n], lo, b0, b1);\n"
    assert text.count(lo_term) == 1
    common.write_text(text.replace(lo_term, ""))
    mutant = _build.build_library(str(src), str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", mutant)
    for what, got, want in _kernels_and_plain(causal):
        err = flash.kernel_error(got, want)
        print(f"bf16 products, causal={causal}: {what} {err}")
        if what != "lse":  # the forward's lse takes no product with P
            assert not err["ok"], (what, err)


@pytest.mark.cuda
def test_kernels_raise_on_what_they_do_not_take() -> None:
    _cuda()
    x = torch.zeros((1, 128, 2, 64), device="cuda")  # f32: not taken
    with pytest.raises(ValueError, match="bf16"):
        flash.flash_attention(x, x, x)
    y = torch.zeros((1, 128, 2, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 64"):
        flash.flash_attention(y, y, y)


@pytest.mark.cuda
def test_model_on_card_runs_the_kernels() -> None:
    _cuda()
    cfg = dataclasses.replace(CONFIGS["tiny"], d_model=128, n_heads=2)
    model = GPT(cfg)  # the default device is cuda
    tok = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len),
                        device="cuda")
    flash.reset_launch_counts()
    loss = model.loss(tok, torch.roll(tok, -1, dims=1))
    loss.backward()
    assert all(n == cfg.n_layers for n in flash.LAUNCHES.values())
    # the same model on the CPU path (reference attention) agrees
    cpu = GPT(cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    with torch.no_grad():
        ref = cpu.loss(tok.cpu(), torch.roll(tok.cpu(), -1, dims=1))
    assert abs(loss.item() - ref.item()) <= LOSS_TOL
    x = torch.randn((1, 128, 2, 64), device="cuda").to(torch.bfloat16)
    got = attention.causal_attention(x, x, x).double()
    want = attention.reference_attention(x, x, x).double()
    diff = (got - want).abs()
    assert bool((diff <= REF_ATOL + REF_RTOL * want.abs()).all())
    assert float(diff.norm() / want.norm()) <= REF_REL_NORM
