"""Dynamic service churn: event timelines + the online embedding engine.

The paper evaluates static VSR sets (1-20 VSRs placed once).  A serving
system sees services *arrive and depart* continuously; this module supplies
both halves of that regime, as the JAX package does:

  * **Timelines** -- non-homogeneous Poisson arrivals (thinning) under a
    24 h diurnal rate profile, exponential service lifetimes, the
    alternating ``churn_trace``, the same-tick waves of
    ``flash_crowd_trace``, scenario presets (``steady``, ``diurnal24``,
    ``burst``), substrate fault timelines (``FaultEvent``; the presets
    ``single_node``, ``rack_storm``, ``brownout_day``) and
    ``merge_timelines`` / ``iter_waves`` to order and group them.  Numpy
    only: the same seed gives the JAX package's events and VSRs.
  * **OnlineEmbedder** -- the live placement state machine: ``add`` /
    ``remove`` carry the previous embedding through ``power.warm_state`` /
    ``power.detach_vsrs`` and re-solve with ``solvers.resolve_incremental``
    (only the churned service's VMs are re-placed; survivors polish in
    place); ``apply_wave`` takes a tick's arrivals and departures in one
    ``solvers.resolve_wave``.  Rejected arrivals may park in a priority
    queue that drains after every capacity-increasing event, a higher
    class may preempt a lower one, and either every ``spec.defrag_every``
    events a full solve (``embed._embed``) re-packs the substrate, never
    worse than the incremental result it replaces, or ``defrag_tick``
    re-sweeps ``spec.defrag_rows_per_tick`` rows at a time.  Substrate
    faults (``fail_node`` / ``fail_link`` and their recoveries) degrade the
    problem under ``spec.health``: services that lost their source are
    stranded in the queue, displaced ones mass re-embedded, and a recovery
    drains the queue.  A ``fault.PlacementMonitor`` counts admission,
    fault and strand events and integrates stranded service time, and a
    ``telemetry.Telemetry`` records spans on the entry points, a solve
    event and an energy-ledger tick per commit.

Random draws come from one CPU ``torch.Generator`` (seed 1 by default),
advanced by every solve.

Times are in hours throughout; rates in services/hour.
"""
from __future__ import annotations

import functools
import heapq
import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from . import embed as embed_mod
from . import power, solvers, vsr
from .power import Device, resolve_device
from .topology import CFNTopology


# ---------------------------------------------------------------------------
# Rate profiles and event timelines
# ---------------------------------------------------------------------------

def diurnal_rate(t_h, base_rate: float, peak_rate: float,
                 peak_hour: float = 20.0):
    """24 h-periodic arrival rate (services/h): a raised cosine between
    ``base_rate`` (quietest, 12 h off-peak) and ``peak_rate`` at
    ``peak_hour``.  Accepts scalars or arrays."""
    phase = 2.0 * np.pi * (np.asarray(t_h, np.float64) - peak_hour) / 24.0  # tracelint: allow[CFN102]
    return base_rate + (peak_rate - base_rate) * 0.5 * (1.0 + np.cos(phase))


@dataclass(frozen=True)
class ServiceEvent:
    """One churn event: service ``sid`` arrives or departs at hour ``t``."""
    t: float
    kind: str          # "arrive" | "depart"
    sid: int


def poisson_timeline(duration_h: float,
                     rate_fn: Callable[[float], float],
                     mean_lifetime_h: float,
                     rng: np.random.Generator | int = 0,
                     max_services: Optional[int] = None
                     ) -> List[ServiceEvent]:
    """Arrival/departure events over ``[0, duration_h)``.

    Arrivals are a non-homogeneous Poisson process with intensity
    ``rate_fn(t)`` sampled by thinning; each arrival draws an Exp(mean)
    lifetime and emits a matching departure if it falls inside the horizon.
    Events are returned time-sorted (departures before arrivals on exact
    ties, so the live set stays minimal).
    """
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    grid = np.linspace(0.0, duration_h, 512)
    lam_max = float(np.max([rate_fn(t) for t in grid]))
    if lam_max <= 0:
        return []
    events: List[ServiceEvent] = []
    t, sid = 0.0, 0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= duration_h:
            break
        if rng.random() <= rate_fn(t) / lam_max:
            events.append(ServiceEvent(t, "arrive", sid))
            t_dep = t + rng.exponential(mean_lifetime_h)
            if t_dep < duration_h:
                events.append(ServiceEvent(t_dep, "depart", sid))
            sid += 1
            if max_services is not None and sid >= max_services:
                break
    events.sort(key=lambda e: (e.t, e.kind == "arrive"))
    return events


def churn_trace(n_steady: int, n_events: int,
                rng: np.random.Generator | int = 0) -> List[ServiceEvent]:
    """The benchmark trace: a steady state of ``n_steady`` live services
    perturbed by alternating single departure / arrival events (depart a
    uniformly random live service, then admit a fresh one), so every event
    is a one-service change."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    events = [ServiceEvent(0.0, "arrive", sid) for sid in range(n_steady)]
    live = list(range(n_steady))
    sid = n_steady
    for i in range(n_events):
        t = 1.0 + i
        if i % 2 == 0:
            victim = live.pop(int(rng.integers(0, len(live))))
            events.append(ServiceEvent(t, "depart", victim))
        else:
            events.append(ServiceEvent(t, "arrive", sid))
            live.append(sid)
            sid += 1
    return events


def flash_crowd_trace(n_steady: int, n_waves: int, wave_size: int,
                      rng: np.random.Generator | int = 0,
                      replace: bool = True) -> List[ServiceEvent]:
    """A flash-crowd timeline: churn arrives in correlated same-tick WAVES
    (the regime ``apply_wave`` / ``replay(..., waves=True)`` batches).

    ``n_steady`` services arrive at t=0, then ``n_waves`` bursts land at
    t = 1, 2, ...:

      * ``replace=True``: each wave departs ``wave_size // 2`` uniformly
        random live services and admits ``wave_size - wave_size // 2``
        fresh ones in the same tick, so the live count never moves.
      * ``replace=False``: ``n_waves`` pure arrival bursts ramp the crowd
        up, then equal departure bursts drain it in LIFO order.

    Within every tick the departures sort before the arrivals
    (``merge_timelines``), so a same-tick replace never double-counts
    capacity."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    events = [ServiceEvent(0.0, "arrive", sid) for sid in range(n_steady)]
    live = list(range(n_steady))
    sid = n_steady
    t = 0.0
    if replace:
        n_dep = wave_size // 2
        for _ in range(n_waves):
            t += 1.0
            for _ in range(n_dep):
                victim = live.pop(int(rng.integers(0, len(live))))
                events.append(ServiceEvent(t, "depart", victim))
            for _ in range(wave_size - n_dep):
                events.append(ServiceEvent(t, "arrive", sid))
                live.append(sid)
                sid += 1
    else:
        crowd: List[int] = []
        for _ in range(n_waves):
            t += 1.0
            for _ in range(wave_size):
                events.append(ServiceEvent(t, "arrive", sid))
                crowd.append(sid)
                sid += 1
        while crowd:
            t += 1.0
            for _ in range(min(wave_size, len(crowd))):
                events.append(ServiceEvent(t, "depart", crowd.pop()))
    return merge_timelines(events)


@dataclass(frozen=True)
class FaultEvent:
    """One substrate fault at hour ``t``: ``fail_node`` / ``recover_node``
    (``target`` = processing-node id), ``fail_link`` / ``recover_link``
    (``target`` = network-element id), ``brownout`` / ``brownout_end``
    (``value`` = the tightened fleet admission budget in watts).  The
    ``*_region`` kinds (``target`` = region index) belong to a
    ``core.federation.FederatedSession``, which also reads ``brownout`` /
    ``brownout_end`` per region; a flat engine refuses them."""
    t: float
    kind: str
    target: int = -1
    value: Optional[float] = None


# Tie-break order at equal t: departures free capacity first, failures land
# before recoveries, and arrivals admit last, onto the settled substrate.
_EVENT_ORDER = {"depart": 0,
                "fail_node": 1, "fail_link": 1, "fail_region": 1,
                "brownout": 1,
                "recover_node": 2, "recover_link": 2, "recover_region": 2,
                "brownout_end": 2,
                "arrive": 3}


def merge_timelines(*streams) -> List:
    """Merge churn (``ServiceEvent``) and fault (``FaultEvent``) streams
    into one time-sorted list, stable within the tie-break order above."""
    events = [e for s in streams for e in s]
    events.sort(key=lambda e: (e.t, _EVENT_ORDER.get(e.kind, 9)))
    return events


def iter_waves(events: Iterable) -> Iterator[List]:
    """Group a time-sorted event stream (``merge_timelines`` output) into
    same-tick waves: maximal runs of ``ServiceEvent``s sharing one
    timestamp, departures first.  Each ``FaultEvent`` is a barrier,
    yielded as its own single-element wave."""
    wave: List = []
    for ev in events:
        if wave and (isinstance(ev, FaultEvent) or ev.t != wave[0].t):
            yield wave
            wave = []
        if isinstance(ev, FaultEvent):
            yield [ev]
        else:
            wave.append(ev)
    if wave:
        yield wave


def _storm_nodes(topo: CFNTopology, n: int) -> List[int]:
    """The first ``n`` nodes to fail in a storm preset: mini-fog servers
    first, then access fog, then the cloud, then anything else."""
    pool: List[int] = []
    for layer in ("mf", "af", "cdc"):
        pool += [p for p in topo.layer_indices(layer) if p not in pool]
    if len(pool) < n:
        pool += [p for p in range(topo.P) if p not in pool]
    return pool[:n]


def single_node(topo: CFNTopology, node: Optional[int] = None,
                t_fail: float = 20.0, outage_h: float = 2.0
                ) -> List[FaultEvent]:
    """One fog node dies at the diurnal peak and recovers ``outage_h``
    later."""
    if node is None:
        node = _storm_nodes(topo, 1)[0]
    return [FaultEvent(t_fail, "fail_node", node),
            FaultEvent(t_fail + outage_h, "recover_node", node)]


def rack_storm(topo: CFNTopology, nodes: Optional[Sequence[int]] = None,
               n_nodes: int = 4, t_fail: float = 20.0,
               stagger_h: float = 0.05, outage_h: float = 1.0
               ) -> List[FaultEvent]:
    """A cascading rack outage: ``n_nodes`` fog nodes (or ``nodes``) fail
    ``stagger_h`` apart and recover in the same order after ``outage_h``."""
    if nodes is None:
        nodes = _storm_nodes(topo, n_nodes)
    ev: List[FaultEvent] = []
    for k, p in enumerate(nodes):
        ev.append(FaultEvent(t_fail + k * stagger_h, "fail_node", int(p)))
        ev.append(FaultEvent(t_fail + outage_h + k * stagger_h,
                             "recover_node", int(p)))
    return merge_timelines(ev)


def brownout_day(topo: CFNTopology, region: int = 0,
                 budget_w: float = 500.0, t0: float = 10.0,
                 t1: float = 16.0) -> List[FaultEvent]:
    """A mid-day brownout: the fleet's admission power budget tightens to
    ``budget_w`` over ``[t0, t1)`` (``region`` is the target a federated
    session reads)."""
    return [FaultEvent(t0, "brownout", region, value=budget_w),
            FaultEvent(t1, "brownout_end", region)]


FAULT_SCENARIOS: Dict[str, Callable] = {
    "single_node": single_node,
    "rack_storm": rack_storm,
    "brownout_day": brownout_day,
}


def fault_preset(name: str, topo: CFNTopology, **kw) -> List[FaultEvent]:
    """Build a named storm preset on a topology (see FAULT_SCENARIOS)."""
    if name not in FAULT_SCENARIOS:
        raise ValueError(f"unknown fault preset {name!r}; choose from "
                         f"{sorted(FAULT_SCENARIOS)}")
    return FAULT_SCENARIOS[name](topo, **kw)


@dataclass(frozen=True)
class ChurnScenario:
    """A named workload regime: rate profile + lifetimes + VSR shape."""
    name: str
    duration_h: float
    base_rate: float           # services/h (off-peak)
    peak_rate: float           # services/h (at peak_hour)
    peak_hour: float
    mean_lifetime_h: float
    n_vms: int = 3
    vm_gflops: Tuple[float, float] = (3.0, 10.0)
    link_mbps: Tuple[float, float] = (5.0, 50.0)
    source_nodes: Tuple[int, ...] = (0,)

    def rate_fn(self) -> Callable[[float], float]:
        return lambda t: float(diurnal_rate(t, self.base_rate,
                                            self.peak_rate, self.peak_hour))

    def timeline(self, rng: np.random.Generator | int = 0
                 ) -> List[ServiceEvent]:
        return poisson_timeline(self.duration_h, self.rate_fn(),
                                self.mean_lifetime_h, rng=rng)

    def sample_vsr(self, rng: np.random.Generator | int) -> vsr.VSRBatch:
        """One fresh service (R=1 VSR) drawn from the scenario's shape."""
        return vsr.random_vsrs(1, rng=rng, n_vms=self.n_vms,
                               source_nodes=list(self.source_nodes),
                               vm_gflops=self.vm_gflops,
                               link_mbps=self.link_mbps)


SCENARIOS: Dict[str, ChurnScenario] = {
    # flat arrival rate; ~8 concurrent services in expectation
    "steady": ChurnScenario("steady", duration_h=24.0, base_rate=2.0,
                            peak_rate=2.0, peak_hour=12.0,
                            mean_lifetime_h=4.0),
    # paper-scale diurnal day: ~4 services overnight, ~20 at the peak
    "diurnal24": ChurnScenario("diurnal24", duration_h=24.0, base_rate=1.0,
                               peak_rate=5.0, peak_hour=20.0,
                               mean_lifetime_h=4.0),
    # short sharp evening burst of small services
    "burst": ChurnScenario("burst", duration_h=6.0, base_rate=0.5,
                           peak_rate=12.0, peak_hour=3.0,
                           mean_lifetime_h=1.0, vm_gflops=(1.0, 4.0)),
}


# ---------------------------------------------------------------------------
# The online embedding engine
# ---------------------------------------------------------------------------

@dataclass
class OnlineStats:
    """Bookkeeping for one engine event."""
    event: str                 # "bootstrap" | "add" | "remove" | "wave"
                               # | "defrag" | "defrag_tick" | "reject"
                               # | "preempt" | "strand" | "fail_node"
                               # | "recover_node" | "fail_link"
                               # | "recover_link"
    method: str
    objective: float
    power_w: float
    n_live: int


@dataclass
class WaveResult:
    """Outcome of one ``apply_wave`` call.

    ``sids`` maps the call's arrivals (input order) to their assigned
    service ids; each of those sids lands in exactly one of ``admitted`` /
    ``rejected`` / ``queued``.  ``result`` is the engine's committed fleet
    ``SolveResult`` after the wave (``None`` once the engine is empty);
    ``n_preempted`` counts live services parked to make room."""
    result: Optional[solvers.SolveResult]
    sids: List[int] = field(default_factory=list)
    admitted: List[int] = field(default_factory=list)
    rejected: List[int] = field(default_factory=list)
    queued: List[int] = field(default_factory=list)
    departed: List[int] = field(default_factory=list)
    n_preempted: int = 0


def _bucket_rows(n: int, lo: int = 2) -> int:
    """Shape bucket for a live-service count: the next power of two (>= lo),
    the JAX package's one bucketing policy (``solvers._pow2``).  Eager
    PyTorch compiles nothing per shape; the buckets keep the problems, and
    so the results, the JAX package's."""
    return solvers._pow2(n, lo=lo)


def _traced(name: str):
    """Wrap an engine entry point in a telemetry span (no-op -- not even a
    context manager allocation -- when no ``Telemetry`` is attached, so
    the disabled path stays bit-identical and free)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            tel = self.telemetry
            if tel is None:
                return fn(self, *args, **kwargs)
            with tel.span(name):
                return fn(self, *args, **kwargs)
        return wrapper
    return deco


class OnlineEmbedder:
    """Live CFN embedding under service churn, on one device.

    Keeps the current VSR set, placement, and incremental
    ``PlacementState``; ``add`` / ``remove`` re-solve with
    ``solvers.resolve_incremental`` (one-service warm-start re-embedding),
    ``apply_wave`` re-solves a tick's churn at once with
    ``solvers.resolve_wave``, and every ``spec.defrag_every`` events -- or
    on demand via ``defrag()`` -- a full solve re-packs the substrate
    (``defrag_tick`` is the amortized alternative).  Service identity is
    the caller's ``sid``; internally rows are dense [0, R).

    Configuration lives in one ``api.PlacementSpec`` (``spec=``; the
    legacy kwarg signature is a deprecated shim that builds a spec).
    Problems are padded to power-of-two service counts and VM widths
    (``spec.bucket_rows`` / ``bucket_cols``), and the sweep position lists
    to the bucket, as in the JAX package.  SLA admission: a scalar
    ``spec.max_hops`` masks every re-solve and the full-solve defrag; with
    ``spec.power_budget_w`` and/or ``spec.violation_tol`` an arrival whose
    power draw or capacity-violation increase exceeds the budget is
    rejected and the engine rolled back -- or, with
    ``spec.queue_rejected``, parked in a priority queue (class, then FIFO)
    and retried after each capacity-increasing event; with
    ``spec.preempt`` a power refusal may park a lower-class live service
    instead.  Counters in ``admission``.

    Faults: ``fail_node`` / ``fail_link`` set ``spec.health`` and re-embed
    on the degraded problem (``power.SubstrateHealth.degrade``: dead
    capacities zeroed, shapes kept); a service whose source died, or which
    has no admissible node left, is stranded in the queue (an arrival at a
    dead source is too, whatever ``queue_rejected`` says), and
    ``recover_*`` re-settles the survivors and drains the queue.  The
    engine clock (``tick``) stamps strand windows for ``monitor`` (a
    ``fault.PlacementMonitor``), which also counts rejections, budget
    violations, preemptions, faults and brownouts at the JAX package's
    points, with its detail strings.  ``telemetry`` (a
    ``telemetry.Telemetry``) gets spans on the entry points, a solve event
    and an energy-ledger tick per commit (with the per-tenant split every
    ``attribution_every`` commits) and the shape and launch attribution.

    ``device=None`` means the CUDA card (and raises without one); random
    draws come from ``generator`` (a CPU ``torch.Generator``, seed 1 by
    default), advanced by every solve.
    """

    def __init__(self, topo: CFNTopology, defrag_every: int = 16,
                 generator: Optional[torch.Generator] = None,
                 sweeps: int = 2, anneal_steps: int = 600,
                 anneal_chains: int = 8, polish_sweeps: int = 2,
                 method: str = "cfn-milp", bucket_rows: bool = True,
                 max_hops: Optional[int] = None,
                 admit_power_budget_w: Optional[float] = None,
                 admit_violation_tol: Optional[float] = None,
                 queue_rejected: bool = False,
                 spec=None, device: Device = None, monitor=None,
                 telemetry=None):
        if spec is None:
            from . import api
            warnings.warn(
                "OnlineEmbedder(defrag_every=..., max_hops=..., ...) kwargs "
                "are deprecated; build a repro_torch.api.PlacementSpec and "
                "pass spec= (or use repro_torch.api.CFNSession)",
                DeprecationWarning, stacklevel=2)
            spec = api.PlacementSpec(
                method=method, defrag_every=defrag_every, max_hops=max_hops,
                power_budget_w=admit_power_budget_w,
                violation_tol=admit_violation_tol,
                queue_rejected=queue_rejected,
                bucket_rows=bucket_rows, bucket_cols=bucket_rows,
                sweeps=sweeps, anneal_steps=anneal_steps,
                anneal_chains=anneal_chains, polish_sweeps=polish_sweeps)
        self.topo = topo
        self.spec = spec
        self.device = resolve_device(device)
        # a fault.PlacementMonitor (optional): admission, fault and strand
        # events are counted there instead of being dropped
        self.monitor = monitor
        # a telemetry.Telemetry (optional): spans on the entry points,
        # energy-ledger ticks and convergence traces on commits, shape and
        # launch attribution.  None keeps every instrumented path a no-op.
        self.telemetry = None
        self._commits_since_attr = 0
        if telemetry is not None:
            self.attach_telemetry(telemetry)
        self._gen = (solvers.default_generator(1) if generator is None
                     else generator)
        self._add_kw = dict(sweeps=spec.sweeps,
                            anneal_steps=spec.anneal_steps,
                            anneal_chains=spec.anneal_chains,
                            anneal_t0=spec.anneal_t0,
                            anneal_t1=spec.anneal_t1,
                            polish_sweeps=spec.polish_sweeps)
        # departures re-pack the survivors: random-restart chains over all
        # free VMs need a hotter start to escape the vacated layout
        self._remove_kw = dict(self._add_kw, sweeps=0,
                               anneal_t0=spec.remove_anneal_t0)
        self.admission = dict(admitted=0, rejected=0, queued=0, preempted=0)
        # the rejection queue is a priority heap of (class, seq, sid,
        # service): class 0 drains first, FIFO (seq) within a class
        self._queue: List[tuple] = []
        self._qseq = 0
        self._vsrs: List[vsr.VSRBatch] = []    # one R=1 batch per service
        self._sids: List[int] = []
        self._prio: List[int] = []             # admission class per live row
        self._next_sid = 0
        # amortized defrag: round-robin row cursor carried across ticks
        self._defrag_cursor = 0
        # the concatenated batch is maintained incrementally (concat /
        # delete-row) and the substrate tensors are built once per engine
        self._batch_cache: Optional[vsr.VSRBatch] = None
        self._substrate: Optional[dict] = None
        self._problem: Optional[power.PlacementProblem] = None
        self._X: Optional[np.ndarray] = None
        self._state: Optional[power.PlacementState] = None
        self._result: Optional[solvers.SolveResult] = None
        self._events_since_defrag = 0
        self.stats: List[OnlineStats] = []
        self._now = 0.0          # engine clock (hours), set by ``tick``
        # the admission budget a brownout replaced, restored by brownout_end
        self._brownout_saved: Optional[tuple] = None

    # -- legacy attribute aliases (read/write through the spec) -----------
    def _spec_alias(name):  # noqa: N805 -- descriptor factory, not a method
        def get(self):
            return getattr(self.spec, name)

        def set_(self, v):
            self.spec = self.spec.replace(**{name: v})
        return property(get, set_)

    defrag_every = _spec_alias("defrag_every")
    method = _spec_alias("method")
    bucket_rows = _spec_alias("bucket_rows")
    max_hops = _spec_alias("max_hops")
    admit_power_budget_w = _spec_alias("power_budget_w")
    admit_violation_tol = _spec_alias("violation_tol")
    queue_rejected = _spec_alias("queue_rejected")
    del _spec_alias

    # -- introspection ----------------------------------------------------
    @property
    def n_live(self) -> int:
        return len(self._vsrs)

    @property
    def sids(self) -> List[int]:
        return list(self._sids)

    @property
    def problem(self) -> Optional[power.PlacementProblem]:
        return self._problem

    @property
    def X(self) -> Optional[np.ndarray]:
        return None if self._X is None else self._X.copy()

    @property
    def result(self) -> Optional[solvers.SolveResult]:
        return self._result

    def service_vms(self, row: int) -> int:
        """The row's OWN VM count (columns beyond it are concat padding)."""
        return self._vsrs[row].V

    def attach_telemetry(self, tel) -> None:
        """Attach (or replace) a ``telemetry.Telemetry``: spans, energy
        ledger, convergence traces and attribution start flowing from the
        next event.  Pass ``None`` to detach."""
        self.telemetry = tel
        if tel is not None:
            if tel.ledger.tiers is None:
                from ..telemetry import tiers_of
                tel.ledger.set_tiers(tiers_of(self.topo))
            tel.attach_traces()

    def _span(self, name: str, **attrs):
        tel = self.telemetry
        return nullcontext() if tel is None else tel.span(name, **attrs)

    def clone(self) -> "OnlineEmbedder":
        """A detached copy sharing the (immutable) arrays: events applied to
        the clone leave this engine untouched.  The clone draws from a copy
        of this engine's generator state."""
        gen = torch.Generator().set_state(self._gen.get_state())
        other = OnlineEmbedder(self.topo, spec=self.spec, generator=gen,
                               device=self.device)
        other._add_kw = dict(self._add_kw)
        other._remove_kw = dict(self._remove_kw)
        other.admission = dict(self.admission)
        other._queue = list(self._queue)
        other._qseq = self._qseq
        other._vsrs = list(self._vsrs)
        other._sids = list(self._sids)
        other._prio = list(self._prio)
        other._next_sid = self._next_sid
        other._defrag_cursor = self._defrag_cursor
        other._batch_cache = self._batch_cache
        other._substrate = self._substrate
        other._problem = self._problem
        other._X = self._X
        other._state = self._state
        other._result = self._result
        other._events_since_defrag = self._events_since_defrag
        other.stats = list(self.stats)
        other._now = self._now
        other._brownout_saved = self._brownout_saved
        return other

    def objective(self) -> float:
        return float("nan") if self._result is None \
            else self._result.objective

    def power_w(self) -> float:
        return 0.0 if self._result is None else self._result.power

    def per_service_power_w(self) -> Dict[int, float]:
        """Per-tenant watts (sums to the total; power.attribute_power)."""
        if self._problem is None or not self._sids:
            return {}
        per = power.attribute_power(self._problem, self._X,
                                    self._result.breakdown,
                                    n_rows=self.n_live)
        return {sid: float(w) for sid, w in zip(self._sids, per)}

    def vsr_batch(self) -> Optional[vsr.VSRBatch]:
        """The live service set as one concatenated VSRBatch (may carry
        zero-demand pad columns from departed wider services)."""
        return self._batch_cache

    # -- internals --------------------------------------------------------
    def _pad_rows(self) -> Optional[int]:
        return (_bucket_rows(len(self._vsrs), lo=self.spec.row_bucket_lo)
                if self.spec.bucket_rows else None)

    def _pad_cols(self) -> Optional[int]:
        """V-width bucket: a wide arrival only widens the problem up to the
        next power of two."""
        if not self.spec.bucket_cols or self._batch_cache is None:
            return None
        return _bucket_rows(self._batch_cache.V, lo=self.spec.col_bucket_lo)

    def _rebuild_problem(self) -> None:
        if self._substrate is None:
            self._substrate = power.substrate_arrays(self.topo, self.device)
        self._problem = power.build_problem(self.topo, self._batch_cache,
                                            substrate=self._substrate,
                                            pad_to_rows=self._pad_rows(),
                                            pad_to_cols=self._pad_cols())
        h = self.spec.health
        if h is not None and not h.all_up:
            # value-only substitution into new tensors: dead capacities
            # zero, same shapes; the cached substrate stays healthy
            self._problem = h.degrade(self._problem)

    def _resolve_kw(self, base: dict) -> dict:
        """Per-event solver kwargs: the sweep list padded to the bucket,
        plus convergence-trace recording when telemetry wants it (host-side
        materialization only: the anneal loop always computes the trace,
        so the flag changes no solve)."""
        kw = dict(base)
        if self.bucket_rows and self._problem is not None:
            kw["pad_positions_to"] = int(
                self._problem.R * (self._problem.V - 1))
        if self.telemetry is not None and self.telemetry.convergence:
            kw["record_conv"] = True
        return kw

    def _drop_row(self, row: int) -> None:
        """Delete one service's row from the cached batch, KEEPING the VM
        width (pad VMs are free)."""
        b = self._batch_cache
        self._batch_cache = vsr.VSRBatch(
            F=np.delete(b.F, row, axis=0), H=np.delete(b.H, row, axis=0),
            src=np.delete(b.src, row), input_vm=np.delete(b.input_vm, row))

    def _snapshot(self) -> tuple:
        """Everything an admission refusal rolls back."""
        return (self._vsrs[:], self._sids[:], self._prio[:],
                self._batch_cache, self._problem, self._X, self._state,
                self._result, self._events_since_defrag)

    def _restore(self, snap: tuple) -> None:
        (self._vsrs, self._sids, self._prio, self._batch_cache,
         self._problem, self._X, self._state, self._result,
         self._events_since_defrag) = snap

    def _commit(self, res: solvers.SolveResult, event: str) -> None:
        self._X = np.asarray(res.X)
        self._state = power.init_state(self._problem, self._X)
        self._result = res
        self.stats.append(OnlineStats(
            event=event, method=res.method, objective=res.objective,
            power_w=res.power, n_live=self.n_live))
        if self.telemetry is not None:
            self._telemetry_commit(res, event)

    def _telemetry_commit(self, res: solvers.SolveResult,
                          event: str) -> None:
        """Record one commit into the attached telemetry: a solve event
        (with the convergence trace when recorded), an energy-ledger tick
        from the commit's breakdown, and -- every
        ``telemetry.attribution_every``-th commit -- the exact per-tenant
        ``power.attribute_power`` split (an O(R) host loop, so it runs on
        a cadence, never per commit by default)."""
        tel = self.telemetry
        per_tenant = None
        every = tel.attribution_every
        if every:
            self._commits_since_attr += 1
            if self._commits_since_attr >= every:
                self._commits_since_attr = 0
                per = power.attribute_power(self._problem, self._X,
                                            res.breakdown,
                                            n_rows=self.n_live)
                per_tenant = {int(s): float(w)
                              for s, w in zip(self._sids, per)}
        tel.record_commit(event=event, res=res, t=self._now,
                          n_live=self.n_live, per_tenant=per_tenant)

    def _full_solve(self, event: str,
                    incumbent: Optional[solvers.SolveResult] = None
                    ) -> solvers.SolveResult:
        """Spec-driven full solve (``spec.method``, ``spec.masks``
        applied); an ``incumbent`` result for the SAME problem (the
        incremental solution, or the live placement on an explicit defrag)
        is kept when the full solve fails to beat it, so defrags never
        regress."""
        res = embed_mod._embed(self.topo, self._batch_cache, self.spec,
                               gen=self._gen, problem=self._problem)
        if incumbent is not None and incumbent.objective < res.objective:
            res = solvers.SolveResult(
                X=incumbent.X, breakdown=incumbent.breakdown,
                method=f"defrag-kept({incumbent.method})",
                history=incumbent.history)
        self._events_since_defrag = 0
        self._commit(res, event)
        return res

    def _carry_loads(self) -> Optional[tuple]:
        if self._state is None:
            return None
        s = self._state
        return (s.omega, s.tm, s.theta, s.lam)

    def _prev_budgets(self) -> Tuple[float, float]:
        """The committed fleet's power and violation, the baselines of an
        arrival's admission test (0 on an empty engine)."""
        if self._result is None:
            return 0.0, 0.0
        return (self._result.power,
                float(self._result.breakdown.violation))

    # -- the priority rejection queue -------------------------------------
    @property
    def queued_sids(self) -> List[int]:
        """Parked service ids in drain order (class, then FIFO)."""
        return [e[2] for e in sorted(self._queue)]

    def _park(self, service: vsr.VSRBatch, sid: int, prio: int = 0,
              seq: Optional[int] = None) -> None:
        """Push one service onto the priority rejection heap.  ``seq``
        re-parks a drained entry at its original within-class position
        (a failed retry keeps its place at the head of its class)."""
        if seq is None:
            seq = self._qseq
            self._qseq += 1
        heapq.heappush(self._queue, (int(prio), seq, sid, service))

    def _source_down(self, service: vsr.VSRBatch) -> bool:
        h = self.spec.health
        return h is not None and not bool(h.node_up[int(service.src[0])])

    def _strand_arrival(self, service: vsr.VSRBatch, sid: int, prio: int,
                        seq: Optional[int] = None, first: bool = True
                        ) -> None:
        """Park an arrival whose pinned source is down.  A fault is not an
        SLA rejection: the arrival parks whatever ``queue_rejected`` says
        and retries on recovery; its ``first`` attempt counts as queued and
        opens its strand window."""
        self._park(service, sid, prio, seq=seq)
        if first:
            self.admission["queued"] += 1
            if self.monitor is not None:
                self.monitor.strand(sid, self._now,
                                    detail=f"sid={sid} source down")
        self.stats.append(OnlineStats(
            event="strand", method="fault", objective=self.objective(),
            power_w=self.power_w(), n_live=self.n_live))

    def _priority_of(self, priority: Optional[int]) -> int:
        prio = 0 if priority is None else int(priority)
        if not 0 <= prio < self.spec.priority_classes:
            raise ValueError(
                f"priority {prio} out of range for "
                f"{self.spec.priority_classes} priority class(es)")
        return prio

    # -- the online API ---------------------------------------------------
    @_traced("bootstrap")
    def bootstrap(self, services: Sequence[vsr.VSRBatch],
                  sids: Optional[Sequence[int]] = None,
                  X0: Optional[np.ndarray] = None,
                  priorities: Optional[Sequence[int]] = None
                  ) -> solvers.SolveResult:
        """Cold-start with a whole service set in ONE full solve instead of
        N incremental admissions.

        ``X0`` [len(services), V0] (optional) ADOPTS a placement computed
        elsewhere (a checkpoint) instead of solving: pins are applied,
        missing columns fill from each row's source, and the engine commits
        the exact evaluation of that placement as its live state.
        ``priorities`` gives each service's admission class (default 0).
        """
        if self._vsrs:
            raise RuntimeError("bootstrap() requires an empty engine")
        if not services:
            raise ValueError("bootstrap() needs at least one service")
        if sids is not None and len(sids) != len(services):
            raise ValueError(f"{len(sids)} sids for {len(services)} services")
        if priorities is not None and len(priorities) != len(services):
            raise ValueError(f"{len(priorities)} priorities for "
                             f"{len(services)} services")
        for k, s in enumerate(services):
            if s.R != 1:
                raise ValueError(f"service {k} must be R=1, got R={s.R}")
        self._vsrs = list(services)
        self._sids = (list(range(len(services))) if sids is None
                      else list(sids))
        self._prio = ([0] * len(services) if priorities is None
                      else [self._priority_of(p) for p in priorities])
        self._next_sid = max(self._sids, default=-1) + 1
        self._batch_cache = vsr.concat_all(self._vsrs)
        self._rebuild_problem()
        self.admission["admitted"] += len(services)
        if X0 is not None:
            X0 = np.asarray(X0)
            if X0.shape[0] != len(services):
                raise ValueError(f"X0 has {X0.shape[0]} rows for "
                                 f"{len(services)} services")
            # shape-map only: adopted rows fill the leading block, extra
            # columns / bucket pad rows fall back to each row's source
            p = self._problem
            h = p.host
            src_of = h.fixed_node[np.arange(p.R), h.fixed_mask.argmax(axis=1)]
            X = np.tile(src_of[:, None], (1, p.V)).astype(np.int32)
            k = min(p.V, X0.shape[1])
            X[:X0.shape[0], :k] = X0[:, :k]
            res = solvers._result(p, X, "bootstrap(adopted)")
            self._events_since_defrag = 0
            self._commit(res, "bootstrap")
            return res
        return self._full_solve("bootstrap")

    @property
    def _positional_constraints(self) -> bool:
        """True when the spec carries ROW-positional constraints (sequence
        ``max_hops`` or an explicit ``eligible`` matrix): churn shifts row
        indices on removal, which would re-assign SLAs to the wrong
        services."""
        return (self.spec.eligible is not None
                or (self.spec.max_hops is not None
                    and np.ndim(self.spec.max_hops) > 0))

    def _check_churn(self, event: str) -> None:
        """Refuse row-positional constraints, which a churn event cannot
        honour."""
        if self._positional_constraints:
            raise ValueError(
                f"{event}() with row-positional constraints (sequence "
                "max_hops / explicit eligible) is unsupported: removal "
                "shifts row indices, mis-assigning per-service SLAs.  Use "
                "a scalar max_hops for churn, or positional constraints "
                "with the static batch path (CFNSession.solve).")

    def _admit_reason(self, res: solvers.SolveResult, prev_power: float,
                      prev_violation: float) -> Optional[str]:
        """SLA admission test on the solved arrival placement: ``None`` when
        admissible, else the name of the violated budget."""
        if (self.admit_power_budget_w is not None
                and res.power - prev_power > self.admit_power_budget_w):
            return "power_budget_exceeded"
        if (self.admit_violation_tol is not None
                and float(res.breakdown.violation) - prev_violation
                > self.admit_violation_tol):
            return "violation_budget_exceeded"
        return None

    @property
    def _admission_active(self) -> bool:
        return (self.max_hops is not None
                or self.admit_power_budget_w is not None
                or self.admit_violation_tol is not None)

    @_traced("add")
    def add(self, service: vsr.VSRBatch, sid: Optional[int] = None,
            priority: Optional[int] = None, _retry: bool = False,
            _qseq: Optional[int] = None) -> Optional[solvers.SolveResult]:
        """Admit one service (an R=1 VSRBatch): warm-start incremental
        re-embedding; the very first service (and every
        ``defrag_every``-th event) takes the full-solve path -- except
        under admission control, where even the first service goes through
        the masked incremental path so the hop/budget contract holds.

        ``priority`` is the service's admission class (0 = most important;
        must be < ``spec.priority_classes``).  Returns ``None`` when
        admission control rejects the arrival (the engine state is rolled
        back; with ``queue_rejected`` the service is parked and retried
        after the next capacity-increasing event).  With ``spec.preempt``,
        a power-budget rejection may instead park a strictly lower-class
        live service (lowest class, newest first) and retry.  ``_retry``
        marks a queue re-attempt: a re-rejection does not re-increment the
        rejected / queued counters (they count distinct arrivals) and
        re-parks the service at its original queue position (``_qseq``),
        while an eventual success still counts as admitted."""
        if service.R != 1:
            raise ValueError(f"add() takes one service, got R={service.R}")
        self._check_churn("add")
        prio = self._priority_of(priority)
        if sid is None:
            sid = self._next_sid
        if sid in self._sids:
            raise ValueError(f"sid {sid} is already live")
        self._next_sid = max(self._next_sid, sid + 1)
        if self._source_down(service):
            self._strand_arrival(service, sid, prio, seq=_qseq,
                                 first=not _retry)
            return None
        prev = self._snapshot()
        prev_X, prev_loads = self._X, self._carry_loads()
        prev_power, prev_viol = self._prev_budgets()
        self._vsrs.append(service)
        self._sids.append(sid)
        self._prio.append(prio)
        self._batch_cache = (service if self._batch_cache is None
                             else self._batch_cache.concat(service))
        self._rebuild_problem()
        self._events_since_defrag += 1
        if prev_X is None and not self._admission_active:
            res = self._full_solve("add")
            self.admission["admitted"] += 1
            return res
        row = self.n_live - 1
        if prev_X is None:
            # empty engine under admission control: start from the pinned
            # sources (an all-src placement) so the masked incremental
            # path and the budget check below still apply
            st = power.init_state(self._problem, self._problem.fixed_node)
        else:
            row_map = list(range(row)) + [-1] * (self._problem.R - row)
            st = power.warm_state(self._problem, prev_X,
                                  prev_loads=prev_loads, row_map=row_map)
        res = solvers.resolve_incremental(
            self._problem, gen=self._gen, changed_rows=[row], state=st,
            spec=self.spec, **self._resolve_kw(self._add_kw))
        reason = self._admit_reason(res, prev_power, prev_viol)
        if reason is not None:
            self._restore(prev)
            if (reason == "power_budget_exceeded" and self.spec.preempt
                    and self._preempt_victim(prio) is not None):
                return self.add(service, sid=sid, priority=prio,
                                _retry=_retry, _qseq=_qseq)
            if self.monitor is not None and not _retry:
                # distinct arrivals only, as admission["rejected"]
                self.monitor.count("admission_rejected", detail=f"sid={sid}")
                self.monitor.count(reason, detail=f"sid={sid}")
            if not _retry:
                self.admission["rejected"] += 1
                if self.queue_rejected:
                    self.admission["queued"] += 1
            if self.queue_rejected or _retry:
                self._park(service, sid, prio, seq=_qseq)
            self.stats.append(OnlineStats(
                event="reject", method="admission", objective=res.objective,
                power_w=res.power, n_live=self.n_live))
            return None
        self.admission["admitted"] += 1
        if self.monitor is not None:
            # closes the strand window of a service a fault parked (no-op
            # otherwise)
            self.monitor.unstrand(sid, self._now)
        if self._defrag_due():
            return self._full_solve("add", incumbent=res)
        self._commit(res, "add")
        return res

    def _preempt_victim(self, prio: int) -> Optional[int]:
        """Park the lowest-class live service strictly below ``prio``
        (newest first on class ties) to free admission budget; returns its
        sid, or ``None`` when no live service may be preempted."""
        victims = [r for r in range(self.n_live) if self._prio[r] > prio]
        if not victims:
            return None
        r = max(victims, key=lambda i: (self._prio[i], i))
        vsid, vsvc, vprio = self._sids[r], self._vsrs[r], self._prio[r]
        # no drain: the arrival that triggered this retries first, and a
        # drain here would just re-admit the victim parked below
        self.remove(vsid, _drain=False)
        self._park(vsvc, vsid, vprio)
        self.admission["preempted"] += 1
        if self.monitor is not None:
            self.monitor.count("preempted", detail=f"sid={vsid}")
        self.stats.append(OnlineStats(
            event="preempt", method="admission", objective=self.objective(),
            power_w=self.power_w(), n_live=self.n_live))
        return vsid

    @_traced("remove")
    def remove(self, sid: int,
               _drain: bool = True) -> Optional[solvers.SolveResult]:
        """Retire a service: detach its loads in O(V*(N+P)), then let the
        survivors re-settle (no changed rows).  Freed capacity re-admits
        queued arrivals (unless ``_drain`` is off).  Returns ``None`` when
        the engine is left empty."""
        self._check_churn("remove")
        row = self._sids.index(sid)
        detached = power.detach_vsrs(self._problem, self._state, [row])
        prev_X = self._X
        surv = [i for i in range(self.n_live) if i != row]
        del self._vsrs[row]
        del self._sids[row]
        del self._prio[row]
        if not self._vsrs:
            self._problem = self._X = self._state = self._result = None
            self._batch_cache = None
            self.stats.append(OnlineStats("remove", "empty", 0.0, 0.0, 0))
            if _drain:
                self._drain_queue()
            return None
        self._drop_row(row)
        self._rebuild_problem()
        self._events_since_defrag += 1
        row_map = surv + [-1] * (self._problem.R - len(surv))
        st = power.warm_state(
            self._problem, prev_X,
            prev_loads=(detached.omega, detached.tm, detached.theta,
                        detached.lam),
            row_map=row_map)
        res = solvers.resolve_incremental(
            self._problem, gen=self._gen, changed_rows=[], state=st,
            spec=self.spec, **self._resolve_kw(self._remove_kw))
        if self._defrag_due():
            res = self._full_solve("remove", incumbent=res)
        else:
            self._commit(res, "remove")
        if _drain:
            self._drain_queue()
        return res

    # -- wave-batched churn ------------------------------------------------
    @_traced("apply_wave")
    def apply_wave(self, arrivals: Sequence = (),
                   departures: Sequence[int] = ()) -> WaveResult:
        """Apply one churn WAVE -- a tick's worth of arrivals and
        departures -- as a single batched engine event.

        ``arrivals``: R=1 ``VSRBatch``es, or ``(service, sid)`` /
        ``(service, sid, priority)`` tuples (``sid=None`` auto-assigns).
        ``departures``: live sids.  Departures detach first in ONE fused
        ``detach_vsrs`` (a same-tick replace never double-counts
        capacity), arrivals join the batch in one concat + problem rebuild,
        ``solvers.resolve_wave`` re-solves the whole wave once, admission
        verdicts land per arrival in priority order, and a
        departure-carrying wave drains the rejection queue.

        A wave of size 1 goes verbatim through ``add`` / ``remove``:
        the same placements, power and admission counters."""
        self._check_churn("apply_wave")
        arr: List[tuple] = []
        seen: set = set()
        for a in arrivals:
            if isinstance(a, (tuple, list)):
                svc = a[0]
                sid = a[1] if len(a) > 1 else None
                prio = self._priority_of(a[2] if len(a) > 2 else 0)
            else:
                svc, sid, prio = a, None, 0
            if svc.R != 1:
                raise ValueError(
                    f"wave arrivals must be R=1, got R={svc.R}")
            if sid is None:
                sid = self._next_sid
            if sid in self._sids or sid in seen:
                raise ValueError(f"sid {sid} is already live")
            seen.add(sid)
            self._next_sid = max(self._next_sid, sid + 1)
            arr.append((svc, int(sid), prio))
        deps = [int(s) for s in departures]
        if len(deps) != len(set(deps)):
            raise ValueError("duplicate departure sid in wave")
        for s in deps:
            if s not in self._sids:
                raise KeyError(f"no live service {s}")
        wr = WaveResult(result=self._result,
                        sids=[sid for _, sid, _ in arr], departed=deps)
        pre_preempted = self.admission["preempted"]
        if not arr and not deps:
            return wr
        if len(arr) + len(deps) == 1:
            if deps:
                wr.result = self.remove(deps[0])
            else:
                svc, sid, prio = arr[0]
                res = self.add(svc, sid=sid, priority=prio)
                if res is not None:
                    wr.result = res
                    wr.admitted.append(sid)
                else:
                    wr.result = self._result
                    self._verdict(wr, sid)
        else:
            self._wave(arr, deps, wr)
        wr.n_preempted = self.admission["preempted"] - pre_preempted
        return wr

    def _verdict(self, wr: WaveResult, sid: int) -> None:
        """File a refused arrival under ``queued`` when it is parked, else
        ``rejected``."""
        if any(e[2] == sid for e in self._queue):
            wr.queued.append(sid)
        else:
            wr.rejected.append(sid)

    def _wave(self, arr: List[tuple], deps: List[int], wr: WaveResult,
              deferred: Optional[List[tuple]] = None) -> WaveResult:
        """One attempt at a batched wave; admission refusals roll the whole
        attempt back and recurse without the refused arrivals."""
        deferred = [] if deferred is None else deferred
        # source-down arrivals park at once (a recursive attempt sees the
        # filtered list)
        up = []
        for svc, sid, prio in arr:
            if self._source_down(svc):
                self._strand_arrival(svc, sid, prio)
                wr.queued.append(sid)
            else:
                up.append((svc, sid, prio))
        arr = up
        if not arr and not deps:
            wr.result = self._result
            return self._wave_deferred(wr, deferred)
        prev = self._snapshot()
        state, prev_X = self._state, self._X
        prev_power, prev_viol = self._prev_budgets()
        n0 = self.n_live
        # phase 1: departures detach as ONE fused state update, BEFORE any
        # arrival lands (capacity is never double-counted inside a wave)
        dep_rows = sorted(self._sids.index(s) for s in deps)
        if dep_rows:
            state = power.detach_vsrs(self._problem, state, dep_rows)
            for r in reversed(dep_rows):
                del self._vsrs[r]
                del self._sids[r]
                del self._prio[r]
                self._drop_row(r)
        gone = set(dep_rows)
        surv = [i for i in range(n0) if i not in gone]
        # phase 2: arrivals join the batch in one pass
        for svc, sid, prio in arr:
            self._vsrs.append(svc)
            self._sids.append(sid)
            self._prio.append(prio)
            self._batch_cache = (svc if self._batch_cache is None
                                 else self._batch_cache.concat(svc))
        if not self._vsrs:
            self._problem = self._X = self._state = self._result = None
            self._batch_cache = None
            self.stats.append(OnlineStats("wave", "empty", 0.0, 0.0, 0))
            wr.result = None
            self._drain_queue()
            return self._wave_deferred(wr, deferred)
        self._rebuild_problem()
        self._events_since_defrag += len(arr) + len(dep_rows)
        new_rows = list(range(len(surv), self.n_live))
        if prev_X is None:
            # cold wave: every arrival starts at its pinned source (the
            # targeted sweeps re-place them; as add under admission)
            st = power.init_state(self._problem, self._problem.fixed_node)
        else:
            st = power.warm_state(
                self._problem, prev_X,
                prev_loads=(state.omega, state.tm, state.theta, state.lam),
                row_map=surv + [-1] * (self._problem.R - len(surv)))
        # phase 3: ONE batched re-solve for the whole wave
        kw = self._add_kw if new_rows else self._remove_kw
        wave_bucket = 0
        if self.telemetry is not None and new_rows:
            n_pos = int((~self._problem.host.fixed_mask[new_rows]).sum())
            wave_bucket = solvers._pow2(n_pos) if n_pos else 0
        with self._span("resolve_wave", n_arrive=len(new_rows),
                        n_depart=len(deps), wave_bucket=wave_bucket,
                        r_bucket=int(self._problem.R)) as sp:
            res = solvers.resolve_wave(self._problem, st, new_rows,
                                       gen=self._gen, spec=self.spec,
                                       **self._resolve_kw(kw))
            if self.telemetry is not None:
                # the result is on the host already, so the span closes
                # on completed device work without an extra sync
                sp.attrs["objective"] = float(res.objective)
        # phase 4: admission, per arrival in priority order
        if new_rows and self._admission_active:
            refused = self._wave_refusals(res, arr, new_rows,
                                          prev_power, prev_viol)
            if refused:
                self._restore(prev)
                keep = []
                for i, (svc, sid, prio) in enumerate(arr):
                    if i not in refused:
                        keep.append((svc, sid, prio))
                    elif (refused[i] == "power_budget_exceeded"
                          and self.spec.preempt):
                        # retried per event after the wave commits, where
                        # preemption may park a lower-class victim
                        deferred.append((svc, sid, prio))
                    else:
                        self.admission["rejected"] += 1
                        if self.monitor is not None:
                            self.monitor.count("admission_rejected",
                                               detail=f"sid={sid}")
                            self.monitor.count(refused[i],
                                               detail=f"sid={sid}")
                        if self.queue_rejected:
                            self.admission["queued"] += 1
                            self._park(svc, sid, prio)
                            wr.queued.append(sid)
                        else:
                            wr.rejected.append(sid)
                        self.stats.append(OnlineStats(
                            event="reject", method="admission",
                            objective=res.objective, power_w=res.power,
                            n_live=self.n_live))
                return self._wave(keep, deps, wr, deferred)
        # phase 5: commit, then drain freed capacity into queued arrivals
        for _, sid, _ in arr:
            wr.admitted.append(sid)
            self.admission["admitted"] += 1
            if self.monitor is not None:
                self.monitor.unstrand(sid, self._now)
        if self._defrag_due():
            res = self._full_solve("wave", incumbent=res)
        else:
            self._commit(res, "wave")
        wr.result = res
        if deps:
            self._drain_queue()
        return self._wave_deferred(wr, deferred)

    def _wave_deferred(self, wr: WaveResult,
                       deferred: List[tuple]) -> WaveResult:
        """Retry power-refused arrivals per event (``spec.preempt``: each
        may park a lower-class victim to free budget)."""
        for svc, sid, prio in deferred:
            res = self.add(svc, sid=sid, priority=prio)
            if res is not None:
                wr.admitted.append(sid)
                wr.result = res
            else:
                self._verdict(wr, sid)
        return wr

    def _wave_refusals(self, res: solvers.SolveResult, arr: List[tuple],
                       new_rows: List[int], prev_power: float,
                       prev_viol: float) -> Dict[int, str]:
        """Admission verdicts for one solved wave attempt: {arr index ->
        reason}.  The wave's budgets are the per-event budgets times its
        arrival count; when exceeded, ONE arrival is refused per attempt --
        the lowest priority class first, and within it the arrival with
        the highest attributed watts (``power.attribute_power``) when a
        power budget is set, else the newest -- and the rest of the wave is
        re-solved, so higher classes keep their seats."""
        budget, tol = self.admit_power_budget_w, self.admit_violation_tol
        over_power = (budget is not None
                      and res.power - prev_power > budget * len(new_rows))
        over_viol = (tol is not None
                     and float(res.breakdown.violation) - prev_viol
                     > tol * len(new_rows))
        if not over_power and not over_viol:
            return {}
        reason = ("power_budget_exceeded" if over_power
                  else "violation_budget_exceeded")
        lowest = max(prio for _, _, prio in arr)
        cls = [j for j in range(len(arr)) if arr[j][2] == lowest]
        if budget is not None:
            per = power.attribute_power(self._problem, res.X, res.breakdown,
                                        n_rows=self.n_live)
            i = max(cls, key=lambda j: (float(per[new_rows[j]]), j))
        else:
            i = max(cls)
        return {i: reason}

    def _drain_queue(self) -> None:
        """Retry parked arrivals class by class (FIFO within a class);
        stop at the first re-rejection.  Runs after every
        capacity-increasing event: departures (per event or wave),
        node / link recoveries and ``brownout_end``."""
        while self._queue:
            prio, seq, sid, service = heapq.heappop(self._queue)
            if self.add(service, sid=sid, priority=prio, _retry=True,
                        _qseq=seq) is None:
                break                    # add() re-parked it at ``seq``

    def cancel_queued(self, sid: int) -> bool:
        """Drop a parked arrival (its lifetime ended while queued)."""
        n0 = len(self._queue)
        self._queue = [e for e in self._queue if e[2] != sid]
        removed = len(self._queue) < n0
        if removed:
            heapq.heapify(self._queue)
            if self.monitor is not None:
                # a stranded service departing from the queue closes its
                # window without counting as re-embedded
                self.monitor.unstrand(sid, self._now, re_embedded=False)
        return removed

    @_traced("defrag")
    def defrag(self) -> Optional[solvers.SolveResult]:
        """Force a full re-pack of the current service set (keeps the live
        placement when the full solve cannot beat it)."""
        if self._problem is None:
            return None
        return self._full_solve("defrag", incumbent=self._result)

    @_traced("defrag_tick")
    def defrag_tick(self, rows: Optional[int] = None
                    ) -> Optional[solvers.SolveResult]:
        """Amortized background defrag: ONE targeted sweep over the free
        VMs of ``rows`` live services (default
        ``spec.defrag_rows_per_tick``), round-robin from a cursor carried
        across ticks, so over ceil(R / K) ticks every service is
        re-considered without a full solve on the event path.

        Never regressing: the swept placement is committed only when its
        exact objective improves on the incumbent.  The position list is
        padded to a power of two, as in the JAX package.  Returns the
        committed result, or ``None`` when the tick found no improvement
        (or there is nothing to defrag)."""
        k = self.spec.defrag_rows_per_tick if rows is None else int(rows)
        if k <= 0 or self._problem is None or self._result is None:
            return None
        n = self.n_live
        sel = [(self._defrag_cursor + i) % n for i in range(min(k, n))]
        self._defrag_cursor = (self._defrag_cursor + len(sel)) % n
        aux = power.build_aux(self._problem)
        free = aux.free_pos.cpu().numpy()
        pos = free[np.isin(free[:, 0], sel)]
        if pos.shape[0] == 0:
            return None
        pos = solvers._pad_positions(pos, solvers._pow2(int(pos.shape[0])))
        el_np, _, _ = solvers._eligible_np(self.spec.masks(self._problem))
        el_t = (None if el_np is None
                else torch.as_tensor(el_np, device=self._problem.device))
        st, _ = solvers._sweep(self._problem, aux, self._state, pos, el_t)
        res = solvers._result(self._problem, st.X, "defrag_tick")
        if res.objective >= self._result.objective - 1e-9:
            return None
        self._commit(res, "defrag_tick")
        return res

    def _defrag_due(self) -> bool:
        # the amortized mode (defrag_rows_per_tick > 0) REPLACES the
        # periodic full defrag: re-packing happens K rows a tick in
        # defrag_tick(), off the event path
        return (self.spec.defrag_rows_per_tick == 0
                and self.defrag_every > 0
                and self._events_since_defrag >= self.defrag_every)

    # -- fault plane ------------------------------------------------------
    def tick(self, t: float) -> None:
        """Advance the engine clock (hours).  Strand / unstrand timestamps
        -- the availability integral -- come from this clock."""
        self._now = float(t)

    def _health(self) -> "power.SubstrateHealth":
        h = self.spec.health
        return power.SubstrateHealth.fresh(self.topo) if h is None else h

    def _fault_rows(self) -> Tuple[List[int], List[int]]:
        """(stranded, moved) row indices of the live placement under the
        just-updated ``spec.health``: stranded rows lost their pinned
        source -- or every admissible node -- and are parked; moved rows
        have VMs on dead nodes or traffic routed over dead elements and
        get mass re-embedded."""
        h = self.spec.health
        el = self.spec.masks(self._problem)
        pair_ok = h.pair_alive(self._problem)
        all_links = bool(h.link_up.all())
        X = self._X
        stranded: List[int] = []
        moved: List[int] = []
        for r in range(self.n_live):
            svc = self._vsrs[r]
            if not bool(h.node_up[int(svc.src[0])]):
                stranded.append(r)
                continue
            nodes = X[r, :svc.V]
            hit = bool((~h.node_up[nodes]).any())
            if not hit and not all_links:
                uu, vv = np.nonzero(np.asarray(svc.H)[0] > 0)
                if uu.size:
                    hit = bool((~pair_ok[nodes[uu], nodes[vv]]).any())
            if not hit:
                continue
            if el is not None and not bool(el[r].any()):
                # nowhere admissible left: the solvers' all-True fallback
                # must never see this row
                stranded.append(r)
            else:
                moved.append(r)
        return stranded, moved

    def _apply_fault_impl(self, event: str) -> Optional[solvers.SolveResult]:
        """Shared fail / recover re-embedding: strand rows that lost their
        source (parked in the queue, never dropped), mass re-embed the
        displaced rows through ``warm_state`` + ``resolve_incremental`` on
        the degraded problem.  A failed element that hosts nothing only
        re-scores the placement on the degraded problem ("untouched")."""
        if self._X is None:
            return None     # nothing placed; _rebuild_problem degrades later
        recovery = event.startswith("recover")
        stranded, moved = ([], []) if recovery else self._fault_rows()
        state = self._state
        prev_X = self._X
        n0 = self.n_live
        if stranded:
            state = power.detach_vsrs(self._problem, state, stranded)
            for r in sorted(stranded, reverse=True):
                sid = self._sids[r]
                self._park(self._vsrs[r], sid, self._prio[r])
                if self.monitor is not None:
                    self.monitor.strand(sid, self._now,
                                        detail=f"sid={sid} {event}")
                del self._vsrs[r]
                del self._sids[r]
                del self._prio[r]
                self._drop_row(r)
        if not self._vsrs:
            self._problem = self._X = self._state = self._result = None
            self._batch_cache = None
            self.stats.append(OnlineStats(event, "empty", 0.0, 0.0, 0))
            return None
        dead = set(stranded)
        surv = [i for i in range(n0) if i not in dead]
        moved_new = [surv.index(r) for r in moved]
        self._rebuild_problem()
        self._events_since_defrag += 1
        st = power.warm_state(
            self._problem, prev_X,
            prev_loads=(state.omega, state.tm, state.theta, state.lam),
            row_map=surv + [-1] * (self._problem.R - len(surv)))
        if not recovery and not moved_new and not stranded:
            # the dead element hosted nothing: re-score the same placement
            # on the degraded problem, no solver work
            res = solvers._result(self._problem, st.X, "untouched")
            self._commit(res, event)
            return res
        kw = self._add_kw if moved_new else self._remove_kw
        res = solvers.resolve_incremental(
            self._problem, gen=self._gen, changed_rows=moved_new, state=st,
            spec=self.spec, **self._resolve_kw(kw))
        if self._defrag_due():
            res = self._full_solve(event, incumbent=res)
        else:
            self._commit(res, event)
        if moved_new and self.monitor is not None:
            self.monitor.count("re_embedded", n=len(moved_new),
                               detail=f"{event}: {len(moved_new)} displaced")
        return res

    def _set_health(self, event: str, target: int,
                    up: bool) -> Optional[solvers.SolveResult]:
        """One fail / recover handler: a no-op (``None``) when ``target``
        is already in that state, else the new health, its monitor count,
        the re-embedding and, on a recovery, the queue drain."""
        self._check_churn(event)
        h = self._health()
        node = event.endswith("node")
        if bool((h.node_up if node else h.link_up)[target]) == up:
            return None
        change = getattr(h, event)
        self.spec = self.spec.replace(health=change(target))
        if self.monitor is not None:
            self.monitor.count(
                ("node_" if node else "link_")
                + ("recovered" if up else "failed"),
                detail=f"{'node' if node else 'link'}={target}")
        res = self._apply_fault_impl(event)
        if up:
            self._drain_queue()
        return res

    def fail_node(self, node: int) -> Optional[solvers.SolveResult]:
        """Fail a processing node: services sourced there are stranded
        (queued for recovery), services with VMs there are mass
        re-embedded on the degraded substrate."""
        return self._set_health("fail_node", node, False)

    def recover_node(self, node: int) -> Optional[solvers.SolveResult]:
        """Recover a node: survivors re-settle onto the restored capacity
        and stranded / parked services retry admission."""
        return self._set_health("recover_node", node, True)

    def fail_link(self, n: int) -> Optional[solvers.SolveResult]:
        """Fail a network element: traffic routed across it is re-embedded
        around the cut (zero C_net penalizes any load left there)."""
        return self._set_health("fail_link", n, False)

    def recover_link(self, n: int) -> Optional[solvers.SolveResult]:
        """Recover a network element: survivors re-settle, parked services
        retry admission."""
        return self._set_health("recover_link", n, True)

    def brownout(self, budget_w: Optional[float]) -> None:
        """Tighten the fleet admission power budget (arrivals beyond it
        reject or queue through the admission path above);
        ``brownout_end`` restores the budget it replaced."""
        if self._brownout_saved is None:
            self._brownout_saved = (self.spec.power_budget_w,)
        self.spec = self.spec.replace(power_budget_w=budget_w)
        if self.monitor is not None:
            self.monitor.count("brownout", detail=f"budget_w={budget_w}")

    def brownout_end(self) -> None:
        """Restore the budget before ``brownout`` and drain the queue."""
        if self._brownout_saved is None:
            return
        (prev_budget,) = self._brownout_saved
        self._brownout_saved = None
        self.spec = self.spec.replace(power_budget_w=prev_budget)
        if self.monitor is not None:
            self.monitor.count("brownout_end",
                               detail=f"budget_w={prev_budget}")
        self._drain_queue()

    @_traced("apply_fault")
    def apply_fault(self, ev: FaultEvent):
        """Dispatch one ``FaultEvent`` to the handlers above (region kinds
        belong to a federated session; a flat engine refuses them)."""
        if ev.kind in ("fail_node", "recover_node", "fail_link",
                       "recover_link"):
            return getattr(self, ev.kind)(int(ev.target))
        if ev.kind == "brownout":
            return self.brownout(ev.value)
        if ev.kind == "brownout_end":
            return self.brownout_end()
        raise ValueError(f"flat engine cannot apply fault kind {ev.kind!r} "
                         "(region faults need a federated session)")


def replay(engine: OnlineEmbedder, events: Sequence[ServiceEvent],
           make_vsr: Callable[[int], vsr.VSRBatch],
           on_event: Optional[Callable] = None,
           waves: bool = False) -> List[OnlineStats]:
    """Drive an engine through a timeline.  ``make_vsr(sid)``
    materializes the service for each arrival; a departure of a service
    that is not live cancels it in the rejection queue (or is skipped).
    ``on_event(event, result)`` observes each step (``result`` is None for
    a rejected arrival or a skipped departure).  Admission counters
    accumulate in ``engine.admission``.

    The timeline may interleave ``FaultEvent``s (``merge_timelines``):
    each dispatches through ``engine.apply_fault``, after which the live
    set is re-read (faults strand, recoveries re-admit).  The engine clock
    is ticked to every event's time, so strand windows are measured on
    the timeline's clock.

    ``waves=True`` batches each same-tick run of churn events
    (``iter_waves``; a fault event is a wave of its own) through
    ``engine.apply_wave`` -- one re-solve per tick instead of one per
    event -- and, when the spec carries an amortized defrag budget
    (``spec.defrag_rows_per_tick``), runs one ``defrag_tick()`` after each
    wave; ``on_event`` then observes ``(event, WaveResult)`` for every
    event of the wave."""
    if waves:
        return _replay_waves(engine, events, make_vsr, on_event)
    live = set(engine.sids)
    for ev in events:
        engine.tick(ev.t)
        if isinstance(ev, FaultEvent):
            res = engine.apply_fault(ev)
            live = set(engine.sids)
        elif ev.kind == "arrive":
            res = engine.add(make_vsr(ev.sid), sid=ev.sid)
            if res is not None:
                live.add(ev.sid)
        elif ev.sid not in live:
            # not live -- but it may be parked in the rejection queue
            engine.cancel_queued(ev.sid)
            res = None
        else:
            res = engine.remove(ev.sid)
            live.discard(ev.sid)
            live.update(engine.sids)       # queue re-admissions
        if on_event is not None:
            on_event(ev, res)
    return engine.stats


def _replay_waves(engine: OnlineEmbedder, events: Sequence,
                  make_vsr: Callable[[int], vsr.VSRBatch],
                  on_event: Optional[Callable]) -> List[OnlineStats]:
    """The ``replay(..., waves=True)`` loop: collect -> apply_wave ->
    background defrag tick, one pass per same-tick wave; a fault event
    is applied on its own."""
    for group in iter_waves(events):
        engine.tick(group[-1].t)
        if isinstance(group[0], FaultEvent):
            res = engine.apply_fault(group[0])
            if on_event is not None:
                on_event(group[0], res)
            continue
        live = set(engine.sids)
        arrivals, departures = [], []
        for ev in group:
            if ev.kind == "arrive":
                arrivals.append((make_vsr(ev.sid), ev.sid))
            elif ev.sid in live:
                departures.append(ev.sid)
            else:
                engine.cancel_queued(ev.sid)
        wres = engine.apply_wave(arrivals, departures)
        if engine.spec.defrag_rows_per_tick:
            engine.defrag_tick()
        if on_event is not None:
            for ev in group:
                on_event(ev, wres)
    return engine.stats
