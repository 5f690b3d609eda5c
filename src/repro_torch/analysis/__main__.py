"""CLI: ``python -m repro_torch.analysis [--baseline FILE] [--format
text|json] [--changed [REF]] [paths...]``.  Exit 0 when every finding is
suppressed (pragma or baseline), 1 otherwise."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from . import engine


def _changed_files(ref: str) -> set:
    """Paths touched vs ``ref`` (diff + untracked), repo-relative."""
    out = subprocess.run(
        ["git", "diff", "--name-only", ref],
        capture_output=True, text=True, check=True).stdout
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard"],
        capture_output=True, text=True, check=True).stdout
    return {ln.strip() for ln in (out + untracked).splitlines() if ln.strip()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="tracelint for the port: torch / CUDA host syncs, "
                    "numerics, shared memory and dataflow static analysis "
                    "(rules CFN101-CFN109; see README.md)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--baseline", metavar="FILE",
                    help="JSON baseline of accepted findings "
                         "(analysis/baseline-torch.json)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write the current findings as a new baseline "
                         "and exit 0")
    ap.add_argument("--changed", metavar="REF", nargs="?", const="HEAD",
                    default=None,
                    help="report only findings in files changed vs REF "
                         "(default HEAD); unchanged files still feed "
                         "cross-module context")
    args = ap.parse_args(argv)

    only = None
    if args.changed is not None:
        try:
            changed = _changed_files(args.changed)
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"error: --changed {args.changed}: {e}", file=sys.stderr)
            return 2
        # restrict REPORTING to changed .py files under the given paths;
        # the full path set still loads so interprocedural facts survive
        roots = [Path(p) for p in args.paths]
        only = set()
        for c in changed:
            p = Path(c)
            if p.suffix != ".py":
                continue
            if any(p == r or r in p.parents for r in roots):
                only.add(str(p))

    findings = engine.analyze_paths(args.paths, only=only)

    if args.write_baseline:
        payload = engine.baseline_payload(findings)
        Path(args.write_baseline).write_text(
            json.dumps(payload, indent=2, sort_keys=True) + "\n")
        print(f"wrote {len(payload['suppressions'])} suppression(s) to "
              f"{args.write_baseline}")
        return 0

    baseline = (engine.load_baseline(args.baseline)
                if args.baseline else set())
    fresh = engine.apply_baseline(findings, baseline)
    n_suppressed = len(findings) - len(fresh)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in fresh],
            "suppressed": n_suppressed,
            "total": len(findings),
        }, indent=2))
    else:
        for f in fresh:
            print(f.render())
        summary = (f"{len(fresh)} finding(s)"
                   + (f", {n_suppressed} baselined" if n_suppressed else ""))
        print(("FAIL: " if fresh else "OK: ") + summary)
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
