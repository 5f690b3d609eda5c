"""The telemetry registry: counters, gauges, log-bucketed histograms, and
a span/trace API emitting JSON-lines events (the JAX package's
``repro.telemetry.registry``, ported).

Everything here is HOST-side: nothing allocates device tensors, and
nothing synchronizes the device unless a span explicitly asks for it via
``sync=`` / ``Span.sync(...)`` -- the one sanctioned synchronization,
taken at the span BOUNDARY so the measured duration covers the device
work launched inside it.

Overhead discipline: the registry is designed so the *disabled* path is a
no-op (callers guard on ``telemetry is None``) and the *enabled* path is
a few dict operations plus one buffered file write per event.

Shape attribution stands where the JAX package has compile attribution:
the port compiles nothing at run time, so ``attach_traces`` hooks
``solvers.count_traces`` -- one record per fresh abstract shape
fingerprint a counted solver entry sees, the set a jit cache would trace
-- and the kernel wrappers' ``LAUNCH_HOOKS``, mirrored as
``launch.<kernel>`` counters.  ``report()`` holds both against the live
``solvers.TRACE_COUNTS`` and kernel ``LAUNCHES`` deltas.

Single-threaded by design (the serving loop is host-single-threaded);
the span stack is a plain list, not thread-local.
"""
from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, IO, List, Optional

from .ledger import EnergyLedger

_EVENT_SCHEMA_VERSION = 1


def _key(name: str, labels: Dict[str, Any]) -> str:
    """Flat metric key: ``name`` or ``name{a=1,b=x}`` (labels sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _bucket_edge(value: float) -> float:
    """Upper edge of ``value``'s log2 bucket: the smallest power of two
    >= value (exact powers of two land on their own edge)."""
    if value <= 0.0:
        return 0.0
    m, e = math.frexp(value)          # value = m * 2**e, 0.5 <= m < 1
    return float(2.0 ** (e - 1 if m == 0.5 else e))


def _kernel_modules() -> tuple:
    from ..kernels import flash_attention, placement_power
    return placement_power, flash_attention


def _launches() -> Dict[str, int]:
    """Every kernel wrapper's live launch count (``LAUNCHES``)."""
    out: Dict[str, int] = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


class Histogram:
    """Log2-bucketed histogram: O(1) observe, ~60 buckets over the full
    float range actually hit, plus exact sum/count/min/max."""

    __slots__ = ("buckets", "sum", "count", "min", "max")

    def __init__(self) -> None:
        self.buckets: Dict[float, int] = {}
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        edge = _bucket_edge(v)
        self.buckets[edge] = self.buckets.get(edge, 0) + 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def snapshot(self) -> Dict[str, Any]:
        return {"sum": self.sum, "count": self.count,
                "min": (None if self.count == 0 else self.min),
                "max": (None if self.count == 0 else self.max),
                "buckets": {str(e): n
                            for e, n in sorted(self.buckets.items())}}


def _sync_devices(value: Any) -> None:
    """Wait for the current stream of every CUDA device holding a tensor
    of ``value`` (a tensor or a pytree of them)."""
    import torch
    from torch.utils._pytree import tree_leaves
    devices = {leaf.device for leaf in tree_leaves(value)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class Span:
    """One timed section.  Context manager; exception-safe (the event is
    emitted with ``ok=False`` and the error type, and the exception
    propagates).  ``sync(value)`` registers a value (a tensor or a pytree
    of them) whose CUDA devices are synchronized at exit, so device work
    launched inside the span is charged to it."""

    __slots__ = ("tel", "name", "attrs", "id", "parent", "t0", "_sync")

    def __init__(self, tel: "Telemetry", name: str,
                 sync: Any = None, **attrs: Any) -> None:
        self.tel = tel
        self.name = name
        self.attrs = attrs
        self._sync = sync
        self.id = -1
        self.parent: Optional[int] = None
        self.t0 = 0.0

    def sync(self, value: Any) -> Any:
        """Synchronize ``value``'s CUDA devices at span exit (returns it
        for chaining); CPU tensors need nothing."""
        self._sync = value
        return value

    def __enter__(self) -> "Span":
        tel = self.tel
        self.id = tel._next_id
        tel._next_id += 1
        self.parent = tel._span_stack[-1] if tel._span_stack else None
        tel._span_stack.append(self.id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._sync is not None:
            _sync_devices(self._sync)
        dur_ms = (time.perf_counter() - self.t0) * 1e3
        tel = self.tel
        if tel._span_stack and tel._span_stack[-1] == self.id:
            tel._span_stack.pop()
        tel.observe(f"span.{self.name}.ms", dur_ms)
        tel.inc(f"span.{self.name}")
        tel.emit("span", name=self.name, id=self.id, parent=self.parent,
                 dur_ms=dur_ms, ok=exc_type is None,
                 err=None if exc_type is None else exc_type.__name__,
                 attrs=self.attrs or None)
        return False                                  # never swallow


class Telemetry:
    """The registry.  One per serving process (or per experiment arm).

    Parameters
    ----------
    jsonl_path:
        When set, every event is appended to this file as one JSON line
        (opened lazily on the first event, closed by ``close()``).
    max_events:
        In-memory event ring bound (the file, when set, gets everything).
    convergence:
        Record solver convergence traces (``SolveResult.conv``) on
        commits.  The traces are fixed-length per effort bucket -- the
        anneal scans always compute them, this flag only controls
        host-side materialization -- so toggling it changes no solve.
    attribution_every:
        Every N-th engine commit additionally runs the exact per-tenant
        ``power.attribute_power`` split (an O(R) host loop) and records
        it into the energy ledger.  ``None`` (default) disables per-tenant
        attribution; keep it cadenced, not per-commit, at R >~ 1000.
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 max_events: int = 65536,
                 convergence: bool = True,
                 attribution_every: Optional[int] = None) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self.events: List[dict] = []
        self.max_events = int(max_events)
        self.convergence = bool(convergence)
        self.attribution_every = attribution_every
        self.jsonl_path = jsonl_path
        self._fh: Optional[IO[str]] = None
        self._span_stack: List[int] = []
        self._next_id = 0
        self.ledger = EnergyLedger(emit=self.emit)
        # shape attribution: records appended by the count_traces hook,
        # kernel launches mirrored by the LAUNCH_HOOKS hook
        self._trace_log: List[dict] = []
        self._trace_base: Optional[Dict[str, int]] = None
        self._trace_hook = None
        self._launch_base: Optional[Dict[str, int]] = None
        self._launch_hook = None

    # -- metrics -----------------------------------------------------------
    def inc(self, name: str, n: float = 1, **labels: Any) -> None:
        k = _key(name, labels)
        self.counters[k] = self.counters.get(k, 0) + n

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        self.gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels: Any) -> None:
        k = _key(name, labels)
        h = self.hists.get(k)
        if h is None:
            h = self.hists[k] = Histogram()
        h.observe(value)

    # -- events ------------------------------------------------------------
    def emit(self, type_: str, **fields: Any) -> dict:
        ev = {"type": type_, "ts": time.time()}
        ev.update(fields)
        self.events.append(ev)
        if len(self.events) > self.max_events:
            del self.events[:len(self.events) - self.max_events]
        if self.jsonl_path is not None:
            if self._fh is None:
                self._fh = open(self.jsonl_path, "a")
                self._fh.write(json.dumps(
                    {"type": "meta", "ts": time.time(),
                     "version": _EVENT_SCHEMA_VERSION}) + "\n")
            self._fh.write(json.dumps(ev) + "\n")
        return ev

    def span(self, name: str, sync: Any = None, **attrs: Any) -> Span:
        return Span(self, name, sync=sync, **attrs)

    # -- shape attribution (count_traces and LAUNCH_HOOKS hooks) ----------
    def attach_traces(self) -> None:
        """Hook ``solvers.count_traces``: every fresh abstract shape
        fingerprint of any counted entry is recorded with a timestamp, the
        entry name and the fingerprint (a ``trace`` event); and the kernel
        wrappers' ``LAUNCH_HOOKS``: every launch ticks ``launch.<kernel>``.
        ``TRACE_COUNTS`` and ``LAUNCHES`` are snapshotted so ``report()``
        can compare recorded vs live deltas."""
        if self._trace_hook is not None:
            return
        from ..core import solvers

        def hook(entry: str, fingerprint: str) -> None:
            rec = {"ts": time.time(), "entry": entry,
                   "fingerprint": fingerprint}
            self._trace_log.append(rec)
            self.inc(f"compile.{entry}")
            self.emit("trace", entry=entry, fingerprint=fingerprint)

        def launch_hook(kernel: str) -> None:
            self.inc(f"launch.{kernel}")

        self._trace_base = dict(solvers.TRACE_COUNTS)
        self._trace_hook = hook
        solvers.TRACE_HOOKS.append(hook)
        self._launch_base = _launches()
        self._launch_hook = launch_hook
        for mod in _kernel_modules():
            mod.LAUNCH_HOOKS.append(launch_hook)

    def detach_traces(self) -> None:
        if self._trace_hook is None:
            return
        from ..core import solvers
        for hooks, hook in ([(solvers.TRACE_HOOKS, self._trace_hook)]
                            + [(mod.LAUNCH_HOOKS, self._launch_hook)
                               for mod in _kernel_modules()]):
            try:
                hooks.remove(hook)
            except ValueError:
                pass
        self._trace_hook = self._launch_hook = None

    def compile_attribution(self) -> List[dict]:
        return list(self._trace_log)

    # -- engine-facing recorders ------------------------------------------
    def record_commit(self, event: str, res: Any, t: float,
                      n_live: int,
                      per_tenant: Optional[Dict[int, float]] = None,
                      per_region: Optional[Dict[str, float]] = None,
                      engine: str = "online") -> None:
        """One engine commit: a ``solve`` event (with the convergence
        trace when recorded) plus an energy-ledger tick from the commit's
        already-computed breakdown (sampling at commits is EXACT for this
        workload model -- power only changes when a placement commits)."""
        bd = res.breakdown
        rec: Dict[str, Any] = {
            "engine": engine, "event": event, "method": res.method,
            "objective": float(res.objective), "power_w": float(res.power),
            "n_live": int(n_live), "t": float(t)}
        conv = getattr(res, "conv", None)
        if conv is not None and self.convergence:
            ds = {}
            for k, v in conv.items():
                step = -(-len(v) // 64) or 1    # <= 64 points per trace
                ds[k] = [float(x) for x in v[::step]]
            rec["conv"] = ds
            if "accept_rate" in conv and len(conv["accept_rate"]):
                self.observe("solve.accept_rate_final",
                             float(conv["accept_rate"][-1]))
        self.emit("solve", **rec)
        self.inc(f"commit.{event}")
        self.ledger.tick(t, total_w=float(bd.total), net_w=float(bd.net),
                         proc_w=float(bd.proc), per_proc=bd.per_proc,
                         per_tenant=per_tenant, per_region=per_region,
                         event=event)

    # -- exporters ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "hists": {k: h.snapshot() for k, h in self.hists.items()}}

    def prometheus(self) -> str:
        """Prometheus-style text exposition of counters, gauges, and
        histograms (cumulative ``le`` buckets)."""
        def sanitize(name: str) -> str:
            base, _, labels = name.partition("{")
            out = "".join(c if c.isalnum() else "_" for c in base)
            return (f"repro_{out}{{{labels}" if labels
                    else f"repro_{out}")

        lines: List[str] = []
        for k in sorted(self.counters):
            lines.append(f"# TYPE {sanitize(k).partition('{')[0]} counter")
            lines.append(f"{sanitize(k)} {self.counters[k]}")
        for k in sorted(self.gauges):
            lines.append(f"# TYPE {sanitize(k).partition('{')[0]} gauge")
            lines.append(f"{sanitize(k)} {self.gauges[k]}")
        for k in sorted(self.hists):
            h = self.hists[k]
            base = sanitize(k).partition("{")[0]
            lines.append(f"# TYPE {base} histogram")
            acc = 0
            for edge in sorted(h.buckets):
                acc += h.buckets[edge]
                lines.append(f'{base}_bucket{{le="{edge}"}} {acc}')
            lines.append(f'{base}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{base}_sum {h.sum}")
            lines.append(f"{base}_count {h.count}")
        return "\n".join(lines) + "\n"

    def report(self, bounds: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
        """Run summary: metrics, integrated energy, the shape attribution
        cross-checked against live ``TRACE_COUNTS`` (``compiles``; and,
        when ``bounds`` -- the ``repro_torch.analysis.compute_cache_bounds``
        dict -- is given, against the CFN108 static bounds) and the
        mirrored kernel launches against the live ``LAUNCHES`` deltas
        (``launches``)."""
        from ..core import solvers
        out = self.snapshot()
        out["energy"] = self.ledger.integrate()
        recorded: Dict[str, int] = {}
        for rec in self._trace_log:
            recorded[rec["entry"]] = recorded.get(rec["entry"], 0) + 1
        compiles: Dict[str, Any] = {"recorded": recorded}
        if self._trace_base is not None:
            live = {k: solvers.TRACE_COUNTS.get(k, 0)
                    - self._trace_base.get(k, 0)
                    for k in set(solvers.TRACE_COUNTS)
                    | set(self._trace_base)}
            live = {k: v for k, v in live.items() if v}
            compiles["live"] = live
            compiles["agree"] = (recorded == live)
        if bounds is not None:
            checks = {}
            for entry, n in recorded.items():
                eb = bounds.get(entry)
                b = None if eb is None else eb.static_bound()
                checks[entry] = {"static_bound": b,
                                 "within": (b is None or n <= b)}
            compiles["bounds"] = checks
        out["compiles"] = compiles
        if self._launch_base is not None:
            rec = {k[len("launch."):]: int(v)
                   for k, v in self.counters.items()
                   if k.startswith("launch.")}
            now = _launches()
            live = {k: now.get(k, 0) - self._launch_base.get(k, 0)
                    for k in set(now) | set(self._launch_base)}
            live = {k: v for k, v in live.items() if v}
            out["launches"] = {"recorded": rec, "live": live,
                               "agree": rec == live}
        return out

    # -- lifecycle ---------------------------------------------------------
    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        """Emit the final ``summary`` event and close the JSONL sink."""
        self.detach_traces()
        self.emit("summary", report=self.report())
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
