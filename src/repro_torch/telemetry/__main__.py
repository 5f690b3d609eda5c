"""CLI: ``python -m repro_torch.telemetry report run.jsonl [--json]``.

Subcommands:
  report   -- summarize a telemetry JSONL run file (spans, joules by
              tier/tenant/region, compile attribution).
  validate -- schema-check the event stream; exit 1 on problems
              (the schema gate).
"""
from __future__ import annotations

import argparse
import json
import sys

from .report import load_events, render, summarize_events, validate_events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.telemetry")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="summarize a run file")
    rp.add_argument("path")
    rp.add_argument("--json", action="store_true",
                    help="machine-readable summary")
    vp = sub.add_parser("validate", help="schema-check a run file")
    vp.add_argument("path")
    args = ap.parse_args(argv)

    events = load_events(args.path)
    if args.cmd == "validate":
        problems = validate_events(events)
        for p in problems:
            print(p, file=sys.stderr)
        print(f"{args.path}: {len(events)} events, "
              f"{len(problems)} schema problems")
        return 1 if problems else 0
    summary = summarize_events(events)
    if args.json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
