"""Run the port's invariant lint suite over the repo.

    python -m torchft_tpu_torch.analysis              # all static checkers
    python -m torchft_tpu_torch.analysis layering     # one checker
    python -m torchft_tpu_torch.analysis --list       # available checkers

Exit status: 0 = clean, 1 = findings (printed one per line as
``path:line: [checker] message``), 2 = usage error. The twin of
``scripts/check.py``; it loads without torch (the package root imports
none, and this package is stdlib only).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import CHECKERS, format_findings, run_all

REPO = Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkers", nargs="*",
                    help=f"subset of {sorted(CHECKERS)} (default: all)")
    ap.add_argument("--root", type=Path, default=REPO,
                    help="tree to lint (default: this repo)")
    ap.add_argument("--list", action="store_true", dest="list_checkers")
    args = ap.parse_args(argv)
    if args.list_checkers:
        for name, scope in sorted(CHECKERS.items()):
            print(f"{name}: scope={list(scope)}")
        return 0
    try:
        findings = run_all(args.root, only=args.checkers or None)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if findings:
        print(format_findings(findings))
        print(f"\n{len(findings)} finding(s).", file=sys.stderr)
        return 1
    names = ", ".join(sorted(args.checkers or CHECKERS))
    print(f"torchft_tpu_torch.analysis: clean ({names})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
