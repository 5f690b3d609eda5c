"""Failure detection: heartbeats, straggler tracking, and placement-plane
counters (a copy of the JAX package's ``fault/monitor.py``: plain Python,
no framework).

Heartbeats and stragglers belong to training (``HeartbeatMonitor``: a
missed heartbeat triggers restart-from-checkpoint; ``StragglerTracker``: a
straggling step raises a mitigation signal).  ``PlacementMonitor`` is the
placement-plane half: the online engine (``core.dynamic.OnlineEmbedder``)
reports admission rejections, power-budget violations, preemptions,
substrate faults and stranded services here instead of dropping them --
the counters an operator alerts on.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class HeartbeatMonitor:
    timeout_s: float = 10.0
    clock: Callable[[], float] = time.monotonic
    last_beat: Dict[str, float] = field(default_factory=dict)

    def register(self, worker: str) -> None:
        self.last_beat[worker] = self.clock()

    def deregister(self, worker: str) -> None:
        """Forget a worker that was evicted or restarted under a new name:
        it stops re-alarming ``dead_workers`` forever."""
        self.last_beat.pop(worker, None)

    def reset(self) -> None:
        """Forget every worker (fleet restart)."""
        self.last_beat.clear()

    def beat(self, worker: str) -> None:
        self.last_beat[worker] = self.clock()

    def dead_workers(self) -> List[str]:
        now = self.clock()
        return [w for w, t in self.last_beat.items()
                if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead_workers()


@dataclass
class PlacementMonitor:
    """Operational counters for the placement control plane.

    Canonical kinds (emitters in parentheses; the ``region_*`` /
    ``cross_region_migration`` / ``evacuation`` kinds come from a federated
    session):
      * ``admission_rejected``    -- an arrival refused by SLA admission
                                     control (OnlineEmbedder.add).
      * ``power_budget_exceeded`` -- the refusal was the incremental power
                                     budget (spec.power_budget_w).
      * ``violation_budget_exceeded`` -- the refusal was the capacity
                                     violation tolerance (spec.violation_tol).
      * ``region_budget_breach``  -- a region's TOTAL watts crossed its
                                     spec.region_power_budget_w
                                     (FederatedSession coordinator).
      * ``cross_region_migration`` -- a service re-homed to another region
                                     after a breach (FederatedSession).

    Fault-plane kinds (the closed loop; see core.dynamic FaultEvent):
      * ``node_failed`` / ``node_recovered`` / ``link_failed`` /
        ``link_recovered``        -- substrate state transitions
                                     (OnlineEmbedder fail/recover handlers).
      * ``region_failed`` / ``region_recovered`` -- federated region faults.
      * ``service_stranded``      -- a service lost its placement (source
                                     node died, or no admissible node
                                     remains) and was parked for retry;
                                     counted by ``strand``.
      * ``re_embedded``           -- a displaced service was re-placed: mass
                                     re-embeds after a fault, and stranded
                                     services re-admitted on recovery
                                     (``unstrand``).
      * ``evacuation``            -- a service moved out of a failed or
                                     browned-out region (FederatedSession).
      * ``brownout`` / ``brownout_end`` -- a power budget tightened /
                                     restored mid-run.

    Availability: ``strand(sid, t)`` opens a window at time ``t`` and
    ``unstrand(sid, t)`` closes it, accumulating into
    ``stranded_service_s`` -- the stranded-service-seconds integral (units
    follow the caller's clock; churn timelines tick in hours).
    ``availability(horizon, n)`` normalizes it to a [0, 1] fraction.

    ``count`` is also open to new kinds; ``events`` keeps the last
    ``max_events`` (kind, detail) pairs for debugging.

    Telemetry delegation: with a telemetry registry attached
    (``attach_telemetry``; any object with ``inc`` / ``emit`` / ``gauge``),
    every ``count`` additionally increments the
    registry counter ``<prefix>.<kind>`` and emits a JSONL ``event`` --
    standalone behavior (``counters`` / ``events`` ring / ``snapshot`` /
    ``merge`` semantics, the ``max_events`` bound) is unchanged, and the
    registry mirror is purely additive.  ``reset()`` does NOT rewind the
    registry (its counters are cumulative across the run by design).
    """

    counters: Dict[str, int] = field(default_factory=dict)
    events: List[Tuple[str, Optional[str]]] = field(default_factory=list)
    max_events: int = 256
    stranded_service_s: float = 0.0
    stranded_since: Dict[int, float] = field(default_factory=dict)
    telemetry: Optional[object] = None
    telemetry_prefix: str = "monitor"

    def attach_telemetry(self, telemetry, prefix: str = "monitor") -> None:
        """Mirror this monitor's counters/events into a telemetry registry
        (``inc`` / ``emit`` / ``gauge``) from now on (``None`` detaches)."""
        self.telemetry = telemetry
        self.telemetry_prefix = prefix

    def count(self, kind: str, detail: Optional[str] = None,
              n: int = 1) -> None:
        self.counters[kind] = self.counters.get(kind, 0) + n
        self.events.append((kind, detail))
        if len(self.events) > self.max_events:
            del self.events[:len(self.events) - self.max_events]
        tel = self.telemetry
        if tel is not None:
            tel.inc(f"{self.telemetry_prefix}.{kind}", n)
            tel.emit("event", kind=kind, detail=detail, n=n)

    def get(self, kind: str) -> int:
        return self.counters.get(kind, 0)

    def __getitem__(self, kind: str) -> int:
        return self.get(kind)

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counters)

    # -- availability integral --------------------------------------------
    def strand(self, sid: int, t: float = 0.0,
               detail: Optional[str] = None) -> None:
        """Open a stranded window for ``sid`` at time ``t`` (idempotent
        while the window is open)."""
        if sid in self.stranded_since:
            return
        self.stranded_since[sid] = float(t)
        self.count("service_stranded", detail or f"sid={sid}")
        if self.telemetry is not None:
            self.telemetry.gauge(f"{self.telemetry_prefix}.stranded_open",
                                 len(self.stranded_since))

    def unstrand(self, sid: int, t: float = 0.0,
                 re_embedded: bool = True) -> bool:
        """Close ``sid``'s stranded window at ``t``, accumulating the
        elapsed span into ``stranded_service_s``.  ``re_embedded=False``
        marks a window closed by departure rather than re-placement.
        No-op (returns False) when no window is open."""
        t0 = self.stranded_since.pop(sid, None)
        if t0 is None:
            return False
        self.stranded_service_s += max(0.0, float(t) - t0)
        if re_embedded:
            self.count("re_embedded", f"sid={sid}")
        if self.telemetry is not None:
            self.telemetry.gauge(f"{self.telemetry_prefix}.stranded_open",
                                 len(self.stranded_since))
            self.telemetry.gauge(
                f"{self.telemetry_prefix}.stranded_service_s",
                self.stranded_service_s)
        return True

    def close_strands(self, t: float) -> int:
        """End-of-horizon flush: close every open window at ``t`` (without
        counting re-embeds) so the integral covers the full run."""
        open_sids = list(self.stranded_since)
        for sid in open_sids:
            self.unstrand(sid, t, re_embedded=False)
        return len(open_sids)

    def availability(self, horizon: float, n_services: int) -> float:
        """1 - stranded time / (horizon * services): the fraction of
        service-time NOT spent stranded.  Flush open windows with
        ``close_strands`` first for an end-of-run reading."""
        denom = float(horizon) * max(int(n_services), 1)
        if denom <= 0.0:
            return 1.0
        return 1.0 - min(self.stranded_service_s / denom, 1.0)

    # -- fleet roll-up -----------------------------------------------------
    def reset(self) -> None:
        """Zero all counters, events, and availability state."""
        self.counters.clear()
        self.events.clear()
        self.stranded_service_s = 0.0
        self.stranded_since.clear()

    def merge(self, other: "PlacementMonitor") -> "PlacementMonitor":
        """Fold ``other`` into this monitor (per-region monitors roll up
        into one fleet snapshot): counters add, event logs concatenate in
        order and keep this monitor's ``max_events`` ring bound, stranded
        integrals add, and open windows keep the earliest start."""
        for kind, n in other.counters.items():
            self.counters[kind] = self.counters.get(kind, 0) + n
            # mirror the fold into the registry -- unless other already
            # reports to the SAME registry (its counts are there already)
            if (self.telemetry is not None
                    and other.telemetry is not self.telemetry):
                self.telemetry.inc(f"{self.telemetry_prefix}.{kind}", n)
        self.events.extend(other.events)
        if len(self.events) > self.max_events:
            del self.events[:len(self.events) - self.max_events]
        self.stranded_service_s += other.stranded_service_s
        for sid, t0 in other.stranded_since.items():
            self.stranded_since[sid] = min(
                t0, self.stranded_since.get(sid, t0))
        return self


@dataclass
class StragglerTracker:
    """Flags steps slower than ``threshold`` x the rolling median."""

    threshold: float = 3.0
    window: int = 32
    times: List[float] = field(default_factory=list)
    flagged_steps: List[int] = field(default_factory=list)

    def reset(self) -> None:
        """Drop the step-time history (restart): pre-failure durations must
        not poison the rolling median of the new incarnation.  Flagged
        steps are a report, not detector state, and are kept."""
        self.times.clear()

    def record(self, step: int, duration_s: float) -> bool:
        history = self.times[-self.window:]
        self.times.append(duration_s)
        if len(history) < 5:
            return False
        med = statistics.median(history)
        if duration_s > self.threshold * med:
            self.flagged_steps.append(step)
            return True
        return False
