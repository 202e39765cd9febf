"""The pure helpers of chip_smoke.py, the port's smoke test on the card.

The script itself needs a GPU: here it must refuse to run (exit 2, no
result line), and its helpers must read a ptxas report (registers and
spills per kernel, the spill gate on the Hopper-redesigned kernels, the
gate on wgmma serialization notes), size the int8 drill's DDP buckets,
and price the flash kernels' bounds and the codec kernels' per wire step.
"""

import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from torchft_tpu_torch.models import CONFIGS, GPT

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(symbol, regs, spill=0):
    return (f"ptxas info    : Compiling entry function '{symbol}' for "
            f"'sm_90a'\nptxas info    : Function properties for {symbol}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
            f"bytes spill loads\nptxas info    : Used {regs} registers, used "
            f"1 barriers\n")


_LOG = "\n".join([
    "== flash_bwd_dq.cu",
    _entry("_ZN3tft19flash_bwd_dq_kernelE14CUtensorMap_stS0_S0_S0_PKfS2_"
           "P13__nv_bfloat16iiffi", 154),
    "== flash_bwd_dkv.cu",
    _entry("_ZN3tft20flash_bwd_dkv_kernelE14CUtensorMap_stS0_S0_S0_PKfS2_"
           "P13__nv_bfloat16S4_iiffi", 168),
    "== flash_fwd.cu",
    "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
    "instructions are serialized",
    _entry("_ZN3tft16flash_fwd_kernelE14CUtensorMap_stS0_S0_P13__nv_bfloat16"
           "Pfiifi", 128),
    "== quant_int8.cu",
    _entry("_ZN3tft23dequant_acc_int8_kernelEPKaxPKfxPfixxxxxi", 32, spill=8),
    _entry("_ZN3tft17quant_int8_kernelEPKfxPaxPfxxxx", 56),
])


def test_ptxas_report_reads_every_kernel() -> None:
    report, notes = _smoke().ptxas_report(_LOG)
    assert report == {
        "flash_bwd_dq": {"registers": 154, "spill_stores": 0,
                         "spill_loads": 0},
        "flash_bwd_dkv": {"registers": 168, "spill_stores": 0,
                          "spill_loads": 0},
        "flash_fwd": {"registers": 128, "spill_stores": 0, "spill_loads": 0},
        "dequant_acc_int8": {"registers": 32, "spill_stores": 8,
                             "spill_loads": 8},
        "quant_int8": {"registers": 56, "spill_stores": 0, "spill_loads": 0},
    }
    assert len(notes) == 1 and "serialized" in notes[0]


@pytest.mark.parametrize("case, want", [
    ("clean", []),
    ("fwd_spills", ["flash_fwd"]),
    ("dkv_missing", ["flash_bwd_dkv"]),
    ("dq_spills", ["flash_bwd_dq"]),
    ("quant_spills", ["quant_int8"]),
    ("codec_spills", []),  # the dequantizer is not redesigned yet
])
def test_spill_gate(case, want) -> None:
    smoke = _smoke()
    report, _ = smoke.ptxas_report(_LOG)  # the dequantizer spills 8 bytes
    if case != "codec_spills":
        report["dequant_acc_int8"].update(spill_stores=0, spill_loads=0)
    if case == "fwd_spills":
        report["flash_fwd"]["spill_loads"] = 4
    elif case == "dkv_missing":
        del report["flash_bwd_dkv"]
    elif case == "dq_spills":
        report["flash_bwd_dq"]["spill_stores"] = 16
    elif case == "quant_spills":
        report["quant_int8"].update(spill_stores=4, spill_loads=4)
    assert smoke.spill_failures(report) == want


def test_serialization_gate() -> None:
    smoke = _smoke()
    _, notes = smoke.ptxas_report(_LOG)
    assert smoke.serialized_notes(notes) == notes  # the C7515 note
    clean = _LOG.replace("(C7515) Potential Performance Loss: wgmma.mma_async "
                         "instructions are serialized", "")
    _, notes = smoke.ptxas_report(clean)
    assert notes == [] and smoke.serialized_notes(notes) == []
    assert smoke.serialized_notes(["ptxas warning : Registers are spilled"]) \
        == []


def test_bucket_sizes_of_the_125m_drill() -> None:
    params = list(GPT(CONFIGS["125m"], device="meta").parameters())
    sizes = _smoke().bucket_sizes(params)
    assert len(sizes) == 15
    assert sorted(set(sizes)) == [787968, 4718592, 7080960, 8262144,
                                  25165824]
    assert sum(sizes) == sum(p.numel() for p in params) == 136091136


def test_attention_bounds_at_125m() -> None:
    bound = _smoke().attention_bound_ms
    fwd, by = bound(8, 1024, 12, 64, True, 2, 4, 1)
    assert by == "bytes" and fwd == pytest.approx(0.015142, rel=1e-4)
    dkv, by = bound(8, 1024, 12, 64, True, 4, 6, 2)
    assert by == "operations" and dkv == pytest.approx(0.026082, rel=1e-4)
    # dq: three products over the 524,800 causal pairs of 96 heads
    dq, by = bound(8, 1024, 12, 64, True, 3, 5, 2)
    assert by == "operations" and dq == pytest.approx(0.019561, rel=1e-4)


def test_codec_step_bounds_at_the_drill_buckets() -> None:
    """The codec kernels' bytes in one wire step of the int8 drill over its
    15 buckets (two groups): quant_int8 moves 5 B an element of the 2 x
    136,091,136 gradients and of the 2 x 68,045,568 reduced shards;
    dequant_acc_int8 6 B an element of the padded sums in phase 1, 5 B in
    phase 2; the scales add 4 B a chunk (a few KB)."""
    smoke = _smoke()
    params = list(GPT(CONFIGS["125m"], device="meta").parameters())
    sizes = smoke.bucket_sizes(params)
    bounds = smoke.codec_step_bound_ms(sizes)
    n = 136091136
    assert bounds["quant_int8"] == pytest.approx(
        (2 * n * 5 + n * 5) / 3.35e12 * 1e3, rel=1e-4)  # 0.6094 ms
    assert bounds["dequant_acc_int8"] == pytest.approx(
        (n * 6 + n * 5) / 3.35e12 * 1e3, rel=1e-4)      # 0.4469 ms
    # per bucket it is the sum of its own shapes: two 787,968 buckets cost
    # twice one
    one = smoke.codec_step_bound_ms([787968])
    two = smoke.codec_step_bound_ms([787968, 787968])
    assert two["quant_int8"] == pytest.approx(2 * one["quant_int8"])


def test_refuses_without_a_card() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    r = subprocess.run([sys.executable, os.path.join(_ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, cwd=_ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_kernel_ab_refuses_without_a_card() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    r = subprocess.run([sys.executable, os.path.join(_ROOT, "kernel_ab.py"),
                        "--tree", "this=torchft_tpu_torch/csrc"],
                       capture_output=True, text=True, timeout=120, cwd=_ROOT)
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr and r.stdout == ""
