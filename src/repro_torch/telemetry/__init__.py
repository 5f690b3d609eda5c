"""repro_torch.telemetry -- the unified observability plane of the port.

A low-overhead, host-side telemetry subsystem for the serving stack, the
JAX package's (``repro.telemetry``) with the same event schema:

* ``Telemetry`` -- the registry: counters, gauges, log2-bucketed
  histograms, a span/trace API (``with tel.span("resolve_wave", ...)``)
  and a JSON-lines event sink;
* ``EnergyLedger`` (``tel.ledger``) -- per-commit watts decomposed into
  Eq.(1) networking vs Eq.(2) processing, per tier / tenant / region,
  integrated to joules over a replay horizon;
* shape attribution -- ``tel.attach_traces()`` hooks
  ``solvers.count_traces`` so every fresh abstract shape fingerprint a
  counted solver entry sees (the set a jit cache would trace) is recorded
  with its entry name, and the kernel wrappers' ``LAUNCH_HOOKS`` so every
  kernel launch ticks a ``launch.<kernel>`` counter; ``tel.report()``
  cross-checks both against the live ``TRACE_COUNTS`` and ``LAUNCHES``;
* exporters -- streaming JSONL, Prometheus text exposition
  (``tel.prometheus()``), and the ``python -m repro_torch.telemetry report``
  CLI.

Threading: pass ``telemetry=`` to ``OnlineEmbedder`` / ``CFNSession`` /
``FederatedSession`` / ``EnergyAwareScheduler`` (default ``None`` keeps
every instrumented path a strict no-op -- bit-identical placements, no
fresh shape fingerprint).
"""
from .ledger import EnergyLedger, tiers_of
from .registry import Histogram, Span, Telemetry
from .report import (EVENT_SCHEMA, load_events, render, summarize_events,
                     validate_events)

__all__ = [
    "Telemetry", "Span", "Histogram", "EnergyLedger", "tiers_of",
    "EVENT_SCHEMA", "load_events", "validate_events", "summarize_events",
    "render",
]
