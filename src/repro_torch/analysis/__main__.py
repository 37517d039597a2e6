"""Command-line entry point: ``python -m repro_torch.analysis [paths...]``.

Exit status: 0 when clean, 1 when there are unsuppressed findings (or
unparsable files), 2 on usage errors.
"""
from __future__ import annotations

import argparse
import sys
from typing import Sequence

from repro_torch.analysis.framework import analyze_paths, render
from repro_torch.analysis.rules import NOT_PORTED, RULES_BY_NAME, get_rules

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "scripts", "tests")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="firstlint for the PyTorch/CUDA port: AST invariant "
                    "checks (hot-path host syncs, block-table cache "
                    "invalidation, CUDA wrapper safety, wire schemas)")
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to check (default: "
             f"{' '.join(DEFAULT_PATHS)})")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (default: text)")
    parser.add_argument(
        "--rules", metavar="NAME[,NAME...]",
        help="comma-separated subset of rules to run")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the available rules and exit")
    return parser


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for name, cls in sorted(RULES_BY_NAME.items()):
            print(f"{name}: {cls.description}")
        for name, why in NOT_PORTED.items():
            print(f"({name}: not ported -- {why})")
        return 0
    try:
        rules = get_rules(
            [n.strip() for n in args.rules.split(",") if n.strip()]
            if args.rules else None)
    except KeyError as exc:
        print(f"error: {exc.args[0]}", file=sys.stderr)
        return 2
    paths = args.paths or list(DEFAULT_PATHS)
    report = analyze_paths(paths, rules)
    if report.files_checked == 0 and not report.findings:
        print("firstlint: no python files found under "
              f"{' '.join(paths)}", file=sys.stderr)
    print(render(report, args.format))
    return 1 if report.findings or report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
