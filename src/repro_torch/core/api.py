"""Unified placement API: one declarative constraint object, one session.

  * **PlacementSpec** -- a frozen, declarative bundle of everything that
    constrains or configures a solve: per-service ``max_hops`` /
    eligibility masks, admission budgets, R- and V-shape bucketing policy,
    portfolio method/effort, and the anneal backend.  ``spec.masks(problem)``
    builds the [R, P] eligibility mask in ONE place; every solver path
    consumes that same mask.
  * **CFNSession** -- the facade owning topology + spec + warm state, on
    one device: ``solve()`` embeds a whole VSR batch (or re-packs the live
    set), ``add`` / ``remove`` are warm-start churn events and
    ``apply_wave`` takes a tick's worth of them at once, ``defrag()``
    re-packs under the SAME spec (``defrag_tick()`` a few rows at a time),
    ``brownout`` / ``brownout_end`` tighten and restore the admission
    budget, ``fail_node`` / ``fail_link`` / ``recover_*`` / ``apply_fault``
    degrade and restore the substrate (``spec.health``), ``attribute()``
    splits fleet watts per tenant, ``replay()`` drives a churn and fault
    timeline and ``savings_vs_baseline`` reports the paper's headline
    metric.  A ``fault.PlacementMonitor`` (``monitor=``) counts
    rejections, preemptions, faults and stranded services.

    from repro_torch.api import CFNSession, PlacementSpec
    spec = PlacementSpec(max_hops=2, power_budget_w=500.0)
    session = CFNSession(topo, spec)         # on the CUDA card by default
    session.solve(vsrs)                      # batch embedding
    session.add(service); session.defrag()   # online churn, masked defrag
    session.apply_wave([(svc, sid)], departures=[old_sid])   # one wave
    session.fail_node(p); session.recover_node(p)            # a fault

  * **FederatedSession** / **RegionPartition** (``core/federation.py``):
    the same facade over several fog regions joined by a shared core
    (region assignment, a region-batched solve, exact fleet accounting,
    cross-region migration on regional budgets, region faults).

Either session takes ``telemetry=`` (a ``repro_torch.telemetry.Telemetry``):
spans, the energy ledger and the shape and launch attribution.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import dynamic, embed as embed_mod, vsr as vsr_mod
from .embed import METHODS
from .power import Device, PlacementProblem, SubstrateHealth, build_problem
from .solvers import SolveResult, solve_portfolio
from .topology import CFNTopology

__all__ = ["PlacementSpec", "CFNSession", "SolveResult", "solve_portfolio",
           "FederatedSession", "RegionPartition", "SubstrateHealth"]

_EFFORTS = ("quick", "standard", "high")
_BACKENDS = ("auto", "delta", "fused", "full")


@dataclass(frozen=True, eq=False)
class PlacementSpec:
    """Declarative constraint + configuration bundle for CFN placement.

    Constraints:
      * ``max_hops`` -- SLA hop bound: every VM of a service must sit within
        this many network hops of the service's source node.  A scalar
        applies to all services; a length-n sequence constrains the first n
        rows.  ``None`` disables.
      * ``eligible`` -- explicit [R, P] bool mask ANDed on top of the hop
        mask (rows beyond its length are unconstrained).
      * ``health`` -- substrate up/down state (``power.SubstrateHealth``):
        dead nodes, and nodes routed from a row's source over a dead
        network element, leave the mask; ``None`` or all-up adds nothing.
    Admission (the online engine): ``power_budget_w`` / ``violation_tol``
    reject an arrival whose power draw / violation increase exceeds them;
    ``queue_rejected`` parks it for a retry after the next
    capacity-increasing event, in ``priority_classes`` classes (0 drains
    first), and ``preempt`` lets a power refusal park a lower-class live
    service instead.  ``defrag_rows_per_tick`` > 0 replaces the periodic
    full solve with ``defrag_tick`` over that many rows.  The batch path
    ignores all of them.  Federation (``FederatedSession`` only; a flat
    session ignores them): ``region_affinity`` / ``region_anti_affinity``
    steer services to / away from a region (scalar, or per batch row),
    ``region_power_budget_w`` (scalar or per region) triggers cross-region
    migration, ``inter_region_hops`` caps the shared-core hops between a
    service's home and host regions.
    Shape bucketing: ``bucket_rows``/``bucket_cols`` pad R and V to
    power-of-two buckets (``row_bucket_lo``/``col_bucket_lo`` the smallest).
    Solver: ``method`` (one of ``embed.METHODS``), ``effort`` ("quick",
    "standard" = +4000-step anneal, "high" = +12000 steps and genetic),
    ``backend`` ("auto"/"delta"/"fused"/"full"); the online engine's
    ``defrag_every`` (a full solve every n churn events, 0 = never) and
    its incremental re-solve knobs (``sweeps``, ``anneal_*``,
    ``remove_anneal_t0``, ``polish_sweeps``).
    """

    # constraints --------------------------------------------------------
    max_hops: Optional[Union[int, Sequence[int], np.ndarray]] = None
    eligible: Optional[np.ndarray] = None
    health: Optional[SubstrateHealth] = None
    # federation ----------------------------------------------------------
    region_affinity: Optional[Union[int, Sequence[int], np.ndarray]] = None
    region_anti_affinity: Optional[Union[int, Sequence[int],
                                         np.ndarray]] = None
    region_power_budget_w: Optional[Union[float, Sequence[float],
                                          np.ndarray]] = None
    inter_region_hops: Optional[int] = None
    # admission budgets ---------------------------------------------------
    power_budget_w: Optional[float] = None
    violation_tol: Optional[float] = None
    queue_rejected: bool = False
    priority_classes: int = 1
    preempt: bool = False
    defrag_rows_per_tick: int = 0
    # bucketing policy ----------------------------------------------------
    bucket_rows: bool = True
    bucket_cols: bool = True
    row_bucket_lo: int = 2
    col_bucket_lo: int = 2
    # portfolio / solver config ------------------------------------------
    method: str = "cfn-milp"
    effort: str = "standard"
    backend: str = "auto"
    defrag_every: int = 16
    sweeps: int = 2
    anneal_steps: int = 600
    anneal_chains: int = 8
    anneal_t0: float = 5.0
    anneal_t1: float = 0.05
    remove_anneal_t0: float = 20.0
    polish_sweeps: int = 2

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; "
                             f"choose from {METHODS}")
        if self.effort not in _EFFORTS:
            raise ValueError(f"unknown effort {self.effort!r}; "
                             f"choose from {_EFFORTS}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choose from {_BACKENDS}")
        if self.row_bucket_lo < 1 or self.col_bucket_lo < 1:
            raise ValueError("bucket floors must be >= 1")
        if self.priority_classes < 1:
            raise ValueError("priority_classes must be >= 1")
        if self.defrag_rows_per_tick < 0:
            raise ValueError("defrag_rows_per_tick must be >= 0")

    def replace(self, **changes) -> "PlacementSpec":
        """A copy with ``changes`` applied (validation re-runs)."""
        return dataclasses.replace(self, **changes)

    # -- the one place constraint masks are built -------------------------
    def masks(self, problem: PlacementProblem) -> Optional[np.ndarray]:
        """The [R, P] node-eligibility mask this spec imposes on a problem,
        or ``None`` when unconstrained.  Hop counts come from the problem's
        own route table, each service's source from its pinned input VM;
        a degraded substrate (``health``) is ANDed in first."""
        h_active = self.health is not None and not self.health.all_up
        if self.max_hops is None and self.eligible is None and not h_active:
            return None
        R, P = problem.R, problem.P
        el = np.ones((R, P), dtype=bool)
        if h_active:
            el &= self.health.eligibility(problem)
        if self.max_hops is not None:
            hops = (problem.route_idx < problem.N).sum(-1).cpu().numpy()
            fixed_mask = problem.fixed_mask.cpu().numpy()
            fixed_node = problem.fixed_node.cpu().numpy()
            src_of = fixed_node[np.arange(R), fixed_mask.argmax(axis=1)]
            mh = np.asarray(self.max_hops)
            lim = np.full(R, np.iinfo(np.int64).max)
            if mh.ndim == 0:
                lim[:] = int(mh)
            else:
                n = min(R, mh.shape[0])
                lim[:n] = mh[:n]
            el &= hops[src_of] <= lim[:, None]
        if self.eligible is not None:
            ex = np.asarray(self.eligible, bool)
            n = min(R, ex.shape[0])
            el[:n] &= ex[:n]
        return el


def _split_services(vsrs: vsr_mod.VSRBatch) -> List[vsr_mod.VSRBatch]:
    """A VSRBatch as a list of R=1 services (the session's row
    granularity)."""
    return [vsr_mod.VSRBatch(F=vsrs.F[i:i + 1], H=vsrs.H[i:i + 1],
                             src=vsrs.src[i:i + 1],
                             input_vm=vsrs.input_vm[i:i + 1])
            for i in range(vsrs.R)]


class CFNSession:
    """The CFN placement facade: topology + spec + warm state, one device.

    Batch embedding (``solve(vsrs)``), online churn (``add`` / ``remove``,
    ``apply_wave``), the masked full re-pack (``defrag``, or ``solve()``
    with no batch) and its amortized form (``defrag_tick``), admission
    brownouts, substrate faults (``fail_node`` / ``fail_link`` /
    ``recover_*`` / ``apply_fault``), per-tenant power accounting
    (``attribute``) and timeline replay (``replay``).  The session's engine
    (``core.dynamic.OnlineEmbedder``) carries the placement and the
    incremental load state between events; every solve enforces
    ``spec.masks`` identically.

    ``device=None`` means the CUDA card (and raises without one); random
    draws come from ``generator`` (a CPU ``torch.Generator``, seed 1 by
    default), advanced by every solve.  ``monitor`` (a
    ``fault.PlacementMonitor``) receives the engine's admission, fault and
    strand events; ``telemetry`` (a ``telemetry.Telemetry``) its spans,
    energy ledger and attribution, and an attached monitor mirrors its
    counters there too.
    """

    def __init__(self, topo: CFNTopology,
                 spec: Optional[PlacementSpec] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None, monitor=None, telemetry=None):
        self.topo = topo
        self._engine = dynamic.OnlineEmbedder(
            topo, spec=spec if spec is not None else PlacementSpec(),
            generator=generator, device=device, monitor=monitor,
            telemetry=telemetry)
        if monitor is not None and telemetry is not None:
            monitor.attach_telemetry(telemetry)

    # -- configuration / introspection ------------------------------------
    def attach_monitor(self, monitor) -> None:
        """Attach (or replace, or with ``None`` detach) the
        ``fault.PlacementMonitor`` receiving this session's admission,
        fault and strand events."""
        self._engine.monitor = monitor
        if monitor is not None and self.telemetry is not None:
            monitor.attach_telemetry(self.telemetry)

    def attach_telemetry(self, telemetry) -> None:
        """Attach (or replace) the ``telemetry.Telemetry`` receiving this
        session's spans, energy ledger and attribution; an attached
        monitor mirrors its counters there too."""
        self._engine.attach_telemetry(telemetry)
        if self._engine.monitor is not None and telemetry is not None:
            self._engine.monitor.attach_telemetry(telemetry)

    @property
    def telemetry(self):
        return self._engine.telemetry

    @property
    def spec(self) -> PlacementSpec:
        return self._engine.spec

    @property
    def device(self) -> torch.device:
        return self._engine.device

    @property
    def engine(self) -> "dynamic.OnlineEmbedder":
        """The underlying online engine."""
        return self._engine

    @property
    def n_live(self) -> int:
        return self._engine.n_live

    @property
    def sids(self) -> List[int]:
        return self._engine.sids

    @property
    def problem(self) -> Optional[PlacementProblem]:
        return self._engine.problem

    @property
    def X(self) -> Optional[np.ndarray]:
        return self._engine.X

    @property
    def result(self) -> Optional[SolveResult]:
        return self._engine.result

    @property
    def stats(self) -> List["dynamic.OnlineStats"]:
        return self._engine.stats

    @property
    def admission(self) -> Dict[str, int]:
        return self._engine.admission

    def service_vms(self, row: int) -> int:
        return self._engine.service_vms(row)

    def power_w(self) -> float:
        return self._engine.power_w()

    def objective(self) -> float:
        return self._engine.objective()

    def masks(self) -> Optional[np.ndarray]:
        """The live problem's eligibility mask under this spec."""
        return (None if self.problem is None
                else self.spec.masks(self.problem))

    # -- solving ----------------------------------------------------------
    def solve(self, vsrs: Optional[vsr_mod.VSRBatch] = None
              ) -> SolveResult:
        """Embed a whole VSR batch under the spec, or re-pack the live set.

        With ``vsrs`` (empty session only): the batch becomes the session's
        live services -- one full solve with ``spec.method`` / ``effort``,
        constraint masks applied, rows and VM columns padded to their
        power-of-two buckets when ``spec.bucket_rows`` / ``bucket_cols``
        are set.  Without ``vsrs``: a full re-pack of the live set
        (``defrag()``).
        """
        if vsrs is None:
            if self._engine.problem is None:
                raise ValueError("empty session: pass a VSRBatch to solve()")
            return self._engine.defrag()
        if self._engine.n_live:
            raise ValueError(
                "session already has live services; use add()/remove() for "
                "churn or solve() with no batch to re-pack")
        return self._engine.bootstrap(_split_services(vsrs))

    def add(self, service: vsr_mod.VSRBatch, sid: Optional[int] = None,
            priority: Optional[int] = None) -> Optional[SolveResult]:
        """Admit one service (R=1): warm-start incremental re-embedding
        under the spec's masks and admission budgets.  ``priority`` is the
        admission class (0 = highest; < ``spec.priority_classes``).
        ``None`` = rejected."""
        return self._engine.add(service, sid=sid, priority=priority)

    def remove(self, sid: int) -> Optional[SolveResult]:
        """Retire a service: detach its loads, re-settle survivors."""
        return self._engine.remove(sid)

    def apply_wave(self, arrivals: Sequence = (),
                   departures: Sequence[int] = ()) -> "dynamic.WaveResult":
        """Apply one churn wave (a tick's arrivals + departures) as a
        single batched re-solve (``OnlineEmbedder.apply_wave``): one fused
        detach, one warm-started ``solvers.resolve_wave``, one polish pass,
        priority-ordered admission, queue drain.  A wave of size 1 is the
        per-event ``add`` / ``remove`` path."""
        return self._engine.apply_wave(arrivals, departures)

    def defrag_tick(self, rows: Optional[int] = None) -> Optional[SolveResult]:
        """One amortized background-defrag step
        (``spec.defrag_rows_per_tick`` rows, round-robin, never
        regressing); see ``OnlineEmbedder.defrag_tick``."""
        return self._engine.defrag_tick(rows)

    def defrag(self) -> Optional[SolveResult]:
        """Full re-pack of the live set under ``spec.masks``; keeps the live
        placement when the full solve cannot beat it."""
        return self._engine.defrag()

    def brownout(self, budget_w: Optional[float]) -> None:
        """Tighten the admission power budget (restore with
        ``brownout_end``)."""
        self._engine.brownout(budget_w)

    def brownout_end(self) -> None:
        """Restore the budget before ``brownout``; queued services retry."""
        self._engine.brownout_end()

    # -- fault plane ------------------------------------------------------
    @property
    def health(self) -> Optional[SubstrateHealth]:
        return self._engine.spec.health

    def tick(self, t: float) -> None:
        """Advance the session clock (hours; the availability timestamps)."""
        self._engine.tick(t)

    def fail_node(self, node: int) -> Optional[SolveResult]:
        """Fail a processing node: strand services sourced there, mass
        re-embed displaced VMs on the degraded substrate."""
        return self._engine.fail_node(node)

    def recover_node(self, node: int) -> Optional[SolveResult]:
        """Recover a node: survivors re-settle, stranded services retry."""
        return self._engine.recover_node(node)

    def fail_link(self, n: int) -> Optional[SolveResult]:
        """Fail a network element: traffic routed across it is re-embedded
        around the cut."""
        return self._engine.fail_link(n)

    def recover_link(self, n: int) -> Optional[SolveResult]:
        """Recover a network element: survivors re-settle, stranded
        services retry."""
        return self._engine.recover_link(n)

    def apply_fault(self, ev: "dynamic.FaultEvent"):
        """Dispatch one ``core.dynamic.FaultEvent`` to the handlers above."""
        return self._engine.apply_fault(ev)

    def attribute(self) -> Dict[int, float]:
        """Per-tenant watts {sid: W}, summing to the fleet total."""
        return self._engine.per_service_power_w()

    def replay(self, events: Sequence["dynamic.ServiceEvent"],
               make_vsr: Callable[[int], vsr_mod.VSRBatch],
               on_event: Optional[Callable] = None,
               waves: bool = False) -> list:
        """Drive the session through a churn timeline, fault events
        included (``core.dynamic.replay`` on this session's engine).
        ``waves=True`` batches same-tick events through ``apply_wave`` and
        runs the amortized defrag tick after each wave."""
        return dynamic.replay(self._engine, events, make_vsr, on_event,
                              waves=waves)

    # -- reporting --------------------------------------------------------
    def savings_vs_baseline(self, baseline: str = "cdc") -> dict:
        """Paper headline metric for the live set: power saving vs a
        fixed-layer baseline, BOTH solved under this spec's constraints
        (masks, effort, backend) on an unpadded problem."""
        vsrs = self._engine.vsr_batch()
        if vsrs is None:
            raise ValueError("empty session")
        problem = build_problem(self.topo, vsrs,
                                substrate=self._engine._substrate)
        base = embed_mod._embed(self.topo, vsrs,
                                self.spec.replace(method=baseline),
                                problem=problem)
        opt = embed_mod._embed(self.topo, vsrs, self.spec, problem=problem)
        saving = 1.0 - opt.power / max(base.power, 1e-9)
        return dict(baseline_w=base.power, optimized_w=opt.power,
                    saving_frac=saving, baseline=base, optimized=opt)


# The federation layer (bottom import: it builds on PlacementSpec /
# CFNSession above, and its lazy ``from . import api`` resolves against
# this module mid-initialization without a cycle).
from .federation import FederatedSession, RegionPartition  # noqa: E402
