"""Dynamic service churn: event timelines + the online embedding engine.

The paper evaluates static VSR sets (1-20 VSRs placed once).  A serving
system sees services *arrive and depart* continuously; this module supplies
both halves of that regime, as the JAX package does:

  * **Timelines** -- non-homogeneous Poisson arrivals (thinning) under a
    24 h diurnal rate profile, exponential service lifetimes, the
    alternating ``churn_trace`` and scenario presets (``steady``,
    ``diurnal24``, ``burst``).  Numpy only: the same seed gives the JAX
    package's events and VSRs.
  * **OnlineEmbedder** -- the live placement state machine: ``add`` /
    ``remove`` carry the previous embedding through ``power.warm_state`` /
    ``power.detach_vsrs`` and re-solve with ``solvers.resolve_incremental``
    (only the churned service's VMs are re-placed; survivors polish in
    place).  Every ``spec.defrag_every`` events a full solve
    (``embed._embed``) re-packs the substrate, never worse than the
    incremental result it replaces.

Random draws come from one CPU ``torch.Generator`` (seed 1 by default),
advanced by every event.  Not ported here (ROADMAP Queue 1): the wave
path, the rejection queue, priority classes, preemption and the amortized
``defrag_tick`` (item 5 (b)); faults (item 5 (c)).  Options that need them
raise ``NotImplementedError`` at the first churn event.

Times are in hours throughout; rates in services/hour.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import embed as embed_mod
from . import power, solvers, vsr
from .power import Device, resolve_device
from .topology import CFNTopology

_ITEM_5B = "ROADMAP Queue 1, item 5 (b)"
_ITEM_5C = "ROADMAP Queue 1, item 5 (c)"


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
    event: str                 # "bootstrap" | "add" | "remove" | "defrag"
                               # | "reject"
    method: str
    objective: float
    power_w: float
    n_live: int


def _bucket_rows(n: int, lo: int = 2) -> int:
    """Shape bucket for a live-service count: the next power of two (>= lo),
    the JAX package's one bucketing policy (``solvers._pow2``).  Eager
    PyTorch compiles nothing per shape; the buckets keep the problems, and
    so the results, the JAX package's."""
    return solvers._pow2(n, lo=lo)


class OnlineEmbedder:
    """Live CFN embedding under service churn, on one device.

    Keeps the current VSR set, placement, and incremental
    ``PlacementState``; ``add`` / ``remove`` re-solve with
    ``solvers.resolve_incremental`` (one-service warm-start re-embedding)
    and every ``spec.defrag_every`` events -- or on demand via ``defrag()``
    -- a full solve re-packs the substrate.  Service identity is the
    caller's ``sid``; internally rows are dense [0, R).

    Configuration lives in one ``api.PlacementSpec`` (``spec=``; the
    legacy kwarg signature is a deprecated shim that builds a spec).
    Problems are padded to power-of-two service counts and VM widths
    (``spec.bucket_rows`` / ``bucket_cols``), and the sweep position lists
    to the bucket, as in the JAX package.  SLA admission: a scalar
    ``spec.max_hops`` masks every re-solve and the full-solve defrag; with
    ``spec.power_budget_w`` and/or ``spec.violation_tol`` an arrival whose
    power draw or capacity-violation increase exceeds the budget is
    rejected and the engine rolled back (counters in ``admission``).

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
                 spec=None, device: Device = None):
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
        self._vsrs: List[vsr.VSRBatch] = []    # one R=1 batch per service
        self._sids: List[int] = []
        self._next_sid = 0
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
        other._vsrs = list(self._vsrs)
        other._sids = list(self._sids)
        other._next_sid = self._next_sid
        other._batch_cache = self._batch_cache
        other._substrate = self._substrate
        other._problem = self._problem
        other._X = self._X
        other._state = self._state
        other._result = self._result
        other._events_since_defrag = self._events_since_defrag
        other.stats = list(self.stats)
        other._now = self._now
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

    def _resolve_kw(self, base: dict) -> dict:
        """Per-event solver kwargs: the sweep list padded to the bucket."""
        kw = dict(base)
        if self.bucket_rows and self._problem is not None:
            kw["pad_positions_to"] = int(
                self._problem.R * (self._problem.V - 1))
        return kw

    def _drop_row(self, row: int) -> None:
        """Delete one service's row from the cached batch, KEEPING the VM
        width (pad VMs are free)."""
        b = self._batch_cache
        self._batch_cache = vsr.VSRBatch(
            F=np.delete(b.F, row, axis=0), H=np.delete(b.H, row, axis=0),
            src=np.delete(b.src, row), input_vm=np.delete(b.input_vm, row))

    def _commit(self, res: solvers.SolveResult, event: str) -> None:
        self._X = np.asarray(res.X)
        self._state = power.init_state(self._problem, self._X)
        self._result = res
        self.stats.append(OnlineStats(
            event=event, method=res.method, objective=res.objective,
            power_w=res.power, n_live=self.n_live))

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

    # -- the online API ---------------------------------------------------
    def bootstrap(self, services: Sequence[vsr.VSRBatch],
                  sids: Optional[Sequence[int]] = None,
                  X0: Optional[np.ndarray] = None) -> solvers.SolveResult:
        """Cold-start with a whole service set in ONE full solve instead of
        N incremental admissions.

        ``X0`` [len(services), V0] (optional) ADOPTS a placement computed
        elsewhere (a checkpoint) instead of solving: pins are applied,
        missing columns fill from each row's source, and the engine commits
        the exact evaluation of that placement as its live state.
        """
        if self._vsrs:
            raise RuntimeError("bootstrap() requires an empty engine")
        if not services:
            raise ValueError("bootstrap() needs at least one service")
        if sids is not None and len(sids) != len(services):
            raise ValueError(f"{len(sids)} sids for {len(services)} services")
        for k, s in enumerate(services):
            if s.R != 1:
                raise ValueError(f"service {k} must be R=1, got R={s.R}")
        self._vsrs = list(services)
        self._sids = (list(range(len(services))) if sids is None
                      else list(sids))
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
        """Refuse what a churn event cannot honour: row-positional
        constraints (ValueError), and the spec options of the unported
        wave / queue plane (NotImplementedError)."""
        if self._positional_constraints:
            raise ValueError(
                f"{event}() with row-positional constraints (sequence "
                "max_hops / explicit eligible) is unsupported: removal "
                "shifts row indices, mis-assigning per-service SLAs.  Use "
                "a scalar max_hops for churn, or positional constraints "
                "with the static batch path (CFNSession.solve).")
        s = self.spec
        unported = [name for name, on in (
            ("queue_rejected=True", s.queue_rejected),
            (f"priority_classes={s.priority_classes}",
             s.priority_classes > 1),
            ("preempt=True", s.preempt),
            (f"defrag_rows_per_tick={s.defrag_rows_per_tick}",
             s.defrag_rows_per_tick > 0)) if on]
        if unported:
            raise NotImplementedError(
                f"{event}() with PlacementSpec({', '.join(unported)}) needs "
                f"the rejection queue / priority / amortized-defrag plane, "
                f"not yet ported ({_ITEM_5B})")

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

    def add(self, service: vsr.VSRBatch,
            sid: Optional[int] = None) -> Optional[solvers.SolveResult]:
        """Admit one service (an R=1 VSRBatch): warm-start incremental
        re-embedding; the very first service (and every
        ``defrag_every``-th event) takes the full-solve path -- except
        under admission control, where even the first service goes through
        the masked incremental path so the hop/budget contract holds.
        Returns ``None`` when admission control rejects the arrival (the
        engine state is rolled back)."""
        if service.R != 1:
            raise ValueError(f"add() takes one service, got R={service.R}")
        self._check_churn("add")
        if sid is None:
            sid = self._next_sid
        if sid in self._sids:
            raise ValueError(f"sid {sid} is already live")
        self._next_sid = max(self._next_sid, sid + 1)
        prev = (self._vsrs[:], self._sids[:], self._batch_cache,
                self._problem, self._X, self._state, self._result,
                self._events_since_defrag)
        prev_X, prev_loads = self._X, self._carry_loads()
        self._vsrs.append(service)
        self._sids.append(sid)
        self._batch_cache = (service if self._batch_cache is None
                             else self._batch_cache.concat(service))
        self._rebuild_problem()
        self._events_since_defrag += 1
        if prev_X is None and not self._admission_active:
            res = self._full_solve("add")
            self.admission["admitted"] += 1
            return res
        row = self.n_live - 1
        prev_res = prev[6]
        if prev_X is None:
            # empty engine under admission control: start from the pinned
            # sources (an all-src placement) so the masked incremental
            # path and the budget check below still apply
            st = power.init_state(self._problem, self._problem.fixed_node)
            prev_power, prev_viol = 0.0, 0.0
        else:
            row_map = list(range(row)) + [-1] * (self._problem.R - row)
            st = power.warm_state(self._problem, prev_X,
                                  prev_loads=prev_loads, row_map=row_map)
            prev_power = prev_res.power
            prev_viol = float(prev_res.breakdown.violation)
        res = solvers.resolve_incremental(
            self._problem, gen=self._gen, changed_rows=[row], state=st,
            spec=self.spec, **self._resolve_kw(self._add_kw))
        if self._admit_reason(res, prev_power, prev_viol) is not None:
            (self._vsrs, self._sids, self._batch_cache, self._problem,
             self._X, self._state, self._result,
             self._events_since_defrag) = prev
            self.admission["rejected"] += 1
            self.stats.append(OnlineStats(
                event="reject", method="admission", objective=res.objective,
                power_w=res.power, n_live=self.n_live))
            return None
        self.admission["admitted"] += 1
        if self._defrag_due():
            return self._full_solve("add", incumbent=res)
        self._commit(res, "add")
        return res

    def remove(self, sid: int) -> Optional[solvers.SolveResult]:
        """Retire a service: detach its loads in O(V*(N+P)), then let the
        survivors re-settle (no changed rows).  Returns ``None`` when the
        engine is left empty."""
        self._check_churn("remove")
        row = self._sids.index(sid)
        detached = power.detach_vsrs(self._problem, self._state, [row])
        prev_X = self._X
        surv = [i for i in range(self.n_live) if i != row]
        del self._vsrs[row]
        del self._sids[row]
        if not self._vsrs:
            self._problem = self._X = self._state = self._result = None
            self._batch_cache = None
            self.stats.append(OnlineStats("remove", "empty", 0.0, 0.0, 0))
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
            return self._full_solve("remove", incumbent=res)
        self._commit(res, "remove")
        return res

    def defrag(self) -> Optional[solvers.SolveResult]:
        """Force a full re-pack of the current service set (keeps the live
        placement when the full solve cannot beat it)."""
        if self._problem is None:
            return None
        return self._full_solve("defrag", incumbent=self._result)

    def _defrag_due(self) -> bool:
        return (self.defrag_every > 0
                and self._events_since_defrag >= self.defrag_every)

    def tick(self, t: float) -> None:
        """Advance the engine clock (hours)."""
        self._now = float(t)


def replay(engine: OnlineEmbedder, events: Sequence[ServiceEvent],
           make_vsr: Callable[[int], vsr.VSRBatch],
           on_event: Optional[Callable] = None,
           waves: bool = False) -> List[OnlineStats]:
    """Drive an engine through a timeline, one event at a time.
    ``make_vsr(sid)`` materializes the service for each arrival; departures
    of services that are not live (never admitted, or rejected) are
    skipped.  ``on_event(event, result)`` observes each step (``result`` is
    None for a rejected arrival or a skipped departure).  Admission
    counters accumulate in ``engine.admission``.

    Only ``ServiceEvent``s are taken: fault events raise (the fault plane,
    item 5 (c)), and so does ``waves=True`` (item 5 (b)), before any event
    is applied."""
    if waves:
        raise NotImplementedError(
            f"replay(waves=True) batches same-tick events through "
            f"apply_wave, not yet ported ({_ITEM_5B})")
    events = list(events)
    for ev in events:
        if getattr(ev, "kind", None) not in ("arrive", "depart"):
            raise NotImplementedError(
                f"timeline event {ev!r} is not a service arrival or "
                f"departure; fault events need the fault plane, not yet "
                f"ported ({_ITEM_5C})")
    live = set(engine.sids)
    for ev in events:
        engine.tick(ev.t)
        if ev.kind == "arrive":
            res = engine.add(make_vsr(ev.sid), sid=ev.sid)
            if res is not None:
                live.add(ev.sid)
        elif ev.sid not in live:
            res = None
        else:
            res = engine.remove(ev.sid)
            live.discard(ev.sid)
        if on_event is not None:
            on_event(ev, res)
    return engine.stats
