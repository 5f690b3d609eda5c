"""Offline summarizer for telemetry JSONL run files.

``python -m repro_torch.telemetry report run.jsonl`` loads the event stream a
``Telemetry(jsonl_path=...)`` run wrote and prints the run summary:
event counts, span latency stats, the integrated energy ledger (joules
by tier / tenant / region), availability when the run carried monitor
events, and the shape attribution.  The schema is the JAX package's
(``repro.telemetry``), so either package's validator accepts the other's
stream.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .ledger import EnergyLedger

# per-type required fields (the JSONL event schema ``validate`` checks)
EVENT_SCHEMA: Dict[str, tuple] = {
    "meta": ("ts", "version"),
    "span": ("ts", "name", "id", "dur_ms", "ok"),
    "solve": ("ts", "event", "method", "objective", "power_w", "n_live",
              "t"),
    "energy": ("ts", "t", "total_w", "net_w", "proc_w"),
    "event": ("ts", "kind"),
    "trace": ("ts", "entry", "fingerprint"),
    "summary": ("ts", "report"),
}


def load_events(path: str) -> List[dict]:
    out = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: bad JSON line: {e}") from e
            out.append(ev)
    return out


def validate_events(events: List[dict]) -> List[str]:
    """Schema check: every event needs a known ``type`` and that type's
    required fields.  Returns human-readable problems (empty = valid)."""
    problems = []
    for i, ev in enumerate(events):
        t = ev.get("type")
        if t not in EVENT_SCHEMA:
            problems.append(f"event {i}: unknown type {t!r}")
            continue
        missing = [f for f in EVENT_SCHEMA[t] if f not in ev]
        if missing:
            problems.append(f"event {i} ({t}): missing fields {missing}")
    return problems


def summarize_events(events: List[dict]) -> Dict[str, Any]:
    """Re-derive the run summary from the event stream alone (no live
    registry needed): span stats, re-integrated ledger, compile log."""
    by_type: Dict[str, int] = {}
    spans: Dict[str, Dict[str, float]] = {}
    ledger = EnergyLedger()
    traces: Dict[str, int] = {}
    monitor_counts: Dict[str, int] = {}
    final_report: Optional[dict] = None
    for ev in events:
        t = ev.get("type", "?")
        by_type[t] = by_type.get(t, 0) + 1
        if t == "span":
            s = spans.setdefault(ev["name"],
                                 {"count": 0, "total_ms": 0.0,
                                  "max_ms": 0.0, "errors": 0})
            s["count"] += 1
            s["total_ms"] += ev["dur_ms"]
            s["max_ms"] = max(s["max_ms"], ev["dur_ms"])
            if not ev.get("ok", True):
                s["errors"] += 1
        elif t == "energy":
            ledger.tick(ev["t"], ev["total_w"], ev["net_w"], ev["proc_w"],
                        event=ev.get("event"))
            last = ledger.samples[-1]
            for k in ("tier_w", "tenant_w", "region_w"):
                if k in ev:
                    last[k] = ev[k]
        elif t == "trace":
            traces[ev["entry"]] = traces.get(ev["entry"], 0) + 1
        elif t == "event":
            k = ev.get("kind", "?")
            monitor_counts[k] = monitor_counts.get(k, 0) + ev.get("n", 1)
        elif t == "summary":
            final_report = ev.get("report")
    return {"events_by_type": by_type, "spans": spans,
            "energy": ledger.integrate(), "compiles": traces,
            "monitor": monitor_counts, "final_report": final_report}


def render(summary: Dict[str, Any]) -> str:
    lines = ["== telemetry run summary =="]
    lines.append("events: " + ", ".join(
        f"{k}={v}" for k, v in sorted(summary["events_by_type"].items())))
    if summary["spans"]:
        lines.append("spans:")
        for name, s in sorted(summary["spans"].items()):
            mean = s["total_ms"] / max(s["count"], 1)
            lines.append(
                f"  {name:<24} n={s['count']:<6} mean={mean:8.2f}ms "
                f"max={s['max_ms']:8.2f}ms errors={s['errors']}")
    e = summary["energy"]
    if e.get("samples"):
        lines.append(
            f"energy: {e['joules_total']:.1f} J total "
            f"(net Eq.1 {e['joules_net']:.1f} J, "
            f"proc Eq.2 {e['joules_proc']:.1f} J) over "
            f"t=[{e['t_start']:.2f}, {e['t_end']:.2f}]")
        for dim in ("joules_by_tier", "joules_by_region"):
            if dim in e:
                parts = ", ".join(f"{k}={v:.1f}J"
                                  for k, v in sorted(e[dim].items()))
                lines.append(f"  {dim[10:]}: {parts}")
        if "joules_by_tenant" in e:
            top = sorted(e["joules_by_tenant"].items(),
                         key=lambda kv: -kv[1])[:5]
            lines.append("  top tenants: " + ", ".join(
                f"sid {k}={v:.1f}J" for k, v in top))
    if summary["compiles"]:
        lines.append("compiles: " + ", ".join(
            f"{k}={v}" for k, v in sorted(summary["compiles"].items())))
    if summary["monitor"]:
        lines.append("monitor events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(summary["monitor"].items())))
    rep = summary.get("final_report")
    if rep and rep.get("compiles", {}).get("agree") is not None:
        lines.append("compile attribution agrees with TRACE_COUNTS: "
                     f"{rep['compiles']['agree']}")
    return "\n".join(lines)
