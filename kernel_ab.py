#!/usr/bin/env python3
"""Time the kernels of several kernel trees in turns, on one card.

Each tree is a directory of kernel sources with the C interface of
``torchft_tpu_torch/csrc``: this tree's, or an earlier commit's unpacked
with ``git archive`` into a directory that ``.gitignore`` lists. Run from
the root of a checkout:

    python3 kernel_ab.py --tree parent=archive_check/torchft_tpu_torch/csrc \\
        --tree this=torchft_tpu_torch/csrc

Every tree is built into ``build/kernel_ab/<name>`` and its kernels are
checked as chip_smoke.py checks them: the flash kernels at the 125m shape
(``check_flash``), the int8 codec kernels bitwise at the 125m gradient and
at the shapes of ``quant_cases`` (``check_codec``). Then each kernel is
timed as chip_smoke.py times it (``cuda_ms``), tree after tree, round
after round, so that the trees share the card's clocks and neighbours: the
flash kernels at the 125m shape, the codec kernels at the 125m gradient
and summed over one wire step of the int8 drill (``<kernel>/step``, from
``codec_step_ms``, which checks each bucket's calls bitwise first). Each
wrapper's host time per call (``host_us``) is taken beside. It prints the
card's name and power limit, one line per tree and round, and last a JSON
line ``{"card": ..., "ms": {tree: {kernel: [ms, ...]}}, "host_us": {tree:
{kernel: [us, ...]}}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", required=True,
                        help="NAME=DIR of kernel sources; repeat")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from torchft_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card()
    print(f"nvidia-smi: {card}", flush=True)
    trees = dict(t.split("=", 1) for t in args.tree)
    libs = {}
    for name, path in trees.items():
        libs[name] = _build.build_library(
            os.path.abspath(path),
            os.path.join(_ROOT, "build", "kernel_ab", name))
        report, notes = chip_smoke.ptxas_report(_build.build_log)
        print(f"tree {name} ptxas {report} notes {notes}", flush=True)

    q, k, v, do = chip_smoke.flash_inputs(0)
    x, sizes = chip_smoke.codec_inputs(0)
    calls = {}
    for name, lib in libs.items():
        _build._lib = lib
        print(f"tree {name}", flush=True)
        chip_smoke.check_flash(q, k, v, do)
        check = chip_smoke.Bitwise()
        chip_smoke.check_codec(x, sizes, 0, check)
        check.raise_failed()
        calls[name] = {**chip_smoke.flash_calls(q, k, v, do),
                       **chip_smoke.codec_calls(x)}

    ms = {name: {kern: [] for kern in calls[name]} for name in libs}
    us = {name: {kern: [] for kern in calls[name]} for name in libs}
    for r in range(args.rounds):
        for name, lib in libs.items():
            _build._lib = lib
            for kern, fn in calls[name].items():
                ms[name][kern].append(chip_smoke.cuda_ms(fn))
                us[name][kern].append(chip_smoke.host_us(fn))
            check = chip_smoke.Bitwise()
            for kern, (t, _) in chip_smoke.codec_step_ms(
                    sizes, 0, check).items():
                ms[name].setdefault(f"{kern}/step", []).append(t)
            check.raise_failed()
            print(f"round {r} {name:10s} " + "  ".join(
                f"{kern} {ms[name][kern][-1]:.4f} ms" + (
                    f" {us[name][kern][-1]:.1f} us/call"
                    if kern in us[name] else "") for kern in ms[name]),
                flush=True)
    print(json.dumps({"card": card, "ms": ms, "host_us": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
