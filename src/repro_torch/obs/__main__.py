"""CLI for trace files.

    PYTHONPATH=src python -m repro_torch.obs summarize out.json
    PYTHONPATH=src python -m repro_torch.obs validate out.json \
        --require dataset partition train classifier
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .summarize import format_summary, load_trace, validate_trace


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize / validate repro-obs Chrome trace files "
                    "(written by either package).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize", help="per-span aggregate table")
    s.add_argument("trace", help="trace JSON emitted via --trace")
    s.add_argument("--top", type=int, default=0,
                   help="only show the N hottest span names")

    v = sub.add_parser("validate", help="schema + required-span check")
    v.add_argument("trace")
    v.add_argument("--require", nargs="*", default=[],
                   help="span names/categories that must be present "
                        "(prefix match on 'name.'), e.g. dataset partition")

    args = ap.parse_args(argv)
    doc = load_trace(args.trace)
    if args.cmd == "summarize":
        print(format_summary(doc, top=args.top))
        return 0
    problems = validate_trace(doc, require=args.require)
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    n = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    print(f"OK: {args.trace} valid repro-obs trace "
          f"(version {doc.get('version')}, {n} spans)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
