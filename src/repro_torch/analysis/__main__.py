"""CLI for replaylint: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .framework import UsageError, run_analysis
from .rules import make_rules


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="replaylint: determinism & cross-plane contract checker",
    )
    parser.add_argument(
        "paths", nargs="*", default=["src/repro_torch/core"],
        help="files or directories to analyze (default: src/repro_torch/core)",
    )
    parser.add_argument(
        "--select", metavar="CODES",
        help="comma-separated rule codes to run (e.g. RS001,RS003)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="also print findings silenced by replaylint: disable comments",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in make_rules():
            print(f"{rule.code}  {rule.name}")
            print(f"       {rule.rationale}")
        return 0

    select = None
    if args.select:
        select = [c.strip() for c in args.select.split(",") if c.strip()]

    try:
        result = run_analysis(args.paths, select=select)
    except UsageError as exc:
        print(f"replaylint: error: {exc}", file=sys.stderr)
        return 2

    for finding in result.findings:
        print(finding.render())
    if args.show_suppressed:
        for finding in result.suppressed:
            print(f"{finding.render()} [suppressed]")
    print(
        f"replaylint: {len(result.findings)} finding(s) "
        f"({len(result.suppressed)} suppressed) in {result.n_files} file(s)"
    )
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
