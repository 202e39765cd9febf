"""What the flash kernels' wrappers accept and how their library is built.

The CUDA kernels run only on the card (tests/test_torch_cuda.py), but the
checks around them are plain Python and run here: the shapes and types the
wrappers hand to a kernel or refuse with ``ValueError``, and the build
(``ops/_build.py``), whose extra nvcc flags name a library of their own and
never reach the library the wrappers load. A fake ``nvcc`` stands in for
the CUDA toolkit. The plain versions the wrappers run on the CPU are held
against the JAX package's flash attention (interpret mode) at S = 192, a
length the kernels take in one 192-row forward block and one and a half
128-key dK/dV blocks. The example's ``train_group`` refuses a CUDA run of
a config whose head_dim the kernels do not take before it builds
anything, which needs no card to check.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchft_tpu.ops import flash as jflash
from torchft_tpu_torch.examples.train_ddp import train_group
from torchft_tpu_torch.models import CONFIGS, TransformerConfig
from torchft_tpu_torch.ops import _build, flash

F32_FWD = 1e-5  # plain vs Pallas interpret, f32: summation order only


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [64, 128, 192, 1024])
def test_kernel_inputs_accept_any_multiple_of_64(s, d) -> None:
    q = _bf16((1, s, 3, d))
    flash._check_kernel_inputs("flash_fwd", q, q.clone(), q.clone())
    lse = torch.zeros((1, 3, s))
    flash._check_kernel_inputs("flash_bwd_dkv", q, q, q, q, lse, lse.clone())
    flash._stats(lse, lse, q)


@pytest.mark.parametrize("case, match", [
    ("s96", "multiple of 64"),
    ("s32", "multiple of 64"),
    ("f32", "bf16"),
    ("f16", "bf16"),
    ("head_dim48", "got head_dim 48"),
    ("head_dim256", "got head_dim 256"),
    ("shape_mismatch", "one shape"),
    ("rank3", r"\[B, S, H, D\]"),
    ("strided", "contiguous"),
])
def test_kernel_inputs_refuse(case, match) -> None:
    q = _bf16((2, 128, 3, 64))
    args = [q, q, q]
    if case == "s96":
        args = [_bf16((2, 96, 3, 64))] * 3
    elif case == "s32":
        args = [_bf16((2, 32, 3, 64))] * 3
    elif case == "f32":
        args = [q.float()] * 3
    elif case == "f16":
        args = [q, q.half(), q]
    elif case == "head_dim48":
        args = [_bf16((2, 128, 3, 48))] * 3
    elif case == "head_dim256":
        args = [_bf16((2, 128, 3, 256))] * 3
    elif case == "shape_mismatch":
        args = [q, _bf16((2, 128, 2, 64)), q]
    elif case == "rank3":
        args = [_bf16((128, 3, 64))] * 3
    elif case == "strided":
        args = [q, _bf16((2, 3, 128, 64)).transpose(1, 2), q]
    with pytest.raises(ValueError, match=match):
        flash._check_kernel_inputs("flash_fwd", *args)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_kernel_stats_refuse(bad) -> None:
    q = _bf16((1, 192, 3, 64))
    good = torch.zeros((1, 3, 192))
    lse = (torch.zeros((1, 192, 3)) if bad == "shape"
           else torch.zeros((1, 3, 192), dtype=torch.float64))
    with pytest.raises(ValueError, match="lse"):
        flash._stats(lse, good, q)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_at_s192_matches_jax(causal) -> None:
    """The wrappers' CPU path at S = 192 against the JAX package's kernels
    in interpret mode, f32."""
    rng = np.random.default_rng(192)
    q, k, v = (rng.standard_normal((1, 192, 3, 64)).astype(np.float32)
               for _ in range(3))
    want = jflash.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, block_q=64,
        block_k=64, interpret=True)
    got, lse = flash.flash_attention_with_lse(
        *(torch.tensor(x) for x in (q, k, v)), causal=causal, block_q=64,
        block_k=64)
    assert lse.shape == (1, 3, 192)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= F32_FWD


def test_kernel_head_dims_cover_every_config() -> None:
    """Every model config of the port has a head_dim the kernels take."""
    assert flash.KERNEL_HEAD_DIMS == (16, 32, 64, 128)
    for name, cfg in CONFIGS.items():
        flash.check_head_dim(name, cfg.head_dim)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_train_group_refuses_a_head_dim_the_kernels_do_not_take(
        device) -> None:
    """A CUDA run (the default device) of a config with head_dim 48 stops
    in train_group before anything is built: no card is needed for it to
    raise, and the message names the head_dim."""
    cfg = TransformerConfig(vocab_size=64, d_model=96, n_layers=1,
                            n_heads=2, d_ff=64, max_seq_len=64)
    assert cfg.head_dim == 48
    with pytest.raises(ValueError, match="got head_dim 48"):
        train_group(cfg, replica_group=0, num_groups=1, total_steps=1,
                    device=device)


# ------------------------------------------------------------------ build


def test_build_flags_change_the_digest() -> None:
    base = _build._digest(_build._CSRC)
    mutant = _build._digest(_build._CSRC, ["-DTFT_SPLIT_LO=0"])
    assert base == _build._digest(_build._CSRC, ())
    assert mutant != base
    assert mutant == _build._digest(_build._CSRC, ("-DTFT_SPLIT_LO=0",))
    other = _build._digest(_build._CSRC, ["-DTFT_SPLIT_LO=1"])
    assert other not in (base, mutant)


def test_split_lo_is_on_unless_a_build_asks() -> None:
    """The lo term's switch defaults to on in the one header every kernel
    includes, and no flag of the library's own build turns it off."""
    with open(os.path.join(_build._CSRC, "flash_common.cuh")) as fh:
        common = fh.read()
    assert "#ifndef TFT_SPLIT_LO\n#define TFT_SPLIT_LO 1\n#endif" in common
    assert not any("TFT_SPLIT_LO" in f
                   for f in _build.ARCH_FLAGS + _build.NVCC_FLAGS)
    # every lo-term product sits behind the switch, in the one helper that
    # all three flash kernels multiply a split operand with (wgmma_split)
    with open(os.path.join(_build._CSRC, "hopper.cuh")) as fh:
        hopper = fh.read()
    assert hopper.count("#if TFT_SPLIT_LO") == 1
    assert common.count("#if TFT_SPLIT_LO") == 0
    for name in ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu"):
        with open(os.path.join(_build._CSRC, name)) as fh:
            src = fh.read()
        assert "wgmma_split(" in src and "TFT_SPLIT_LO" not in src, name


def test_default_build_passes_no_extra_flags(monkeypatch) -> None:
    seen = []
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(
        _build, "build_library",
        lambda csrc, build_dir, extra_flags=(): seen.append(
            (csrc, build_dir, tuple(extra_flags))) or "lib")
    assert _build.load_kernels() == "lib"
    assert seen == [(_build._CSRC, _build.BUILD_DIR, ())]


def _fake_nvcc(tmp_path):
    """An nvcc that records its arguments, prints a ptxas line and writes
    an empty file wherever ``-o`` points."""
    path = tmp_path / "nvcc"
    log = tmp_path / "nvcc_calls.txt"
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n"
        "print('ptxas info    : Used 1 registers')\n"
    )
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path), log


@pytest.mark.parametrize("extra", [(), ("-DTFT_SPLIT_LO=0",)])
def test_build_library_passes_its_flags_to_nvcc(tmp_path, monkeypatch,
                                                 extra) -> None:
    nvcc, calls = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_configure", lambda lib: None)
    out = tmp_path / "build"
    lib = _build.build_library(_build._CSRC, str(out), extra_flags=extra)
    digest = _build._digest(_build._CSRC, extra)
    assert os.path.basename(lib) == f"libtft_kernels_{digest}.so"
    lines = calls.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in ln]
    assert len(compiles) == len(_build._sources(_build._CSRC))
    for ln in compiles:
        assert ("-DTFT_SPLIT_LO=0" in ln.split()) == bool(extra)
    assert "Used 1 registers" in _build.build_log
    # a second call finds the library and compiles nothing
    _build.build_library(_build._CSRC, str(out), extra_flags=extra)
    assert calls.read_text().splitlines() == lines
