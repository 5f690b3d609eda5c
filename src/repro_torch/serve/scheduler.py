"""Placement-aware serving scheduler: the paper's technique in the serving
path, a thin consumer of the unified placement API.

Each inference service (an architecture + token rate) becomes a VSR; the
scheduler drives a ``repro_torch.api.CFNSession`` -- or any session with
its interface, passed via ``session=`` -- whose declarative
``PlacementSpec`` carries the constraint set (SLA hop bounds, admission
power budget) and the portfolio configuration.  ``add_service`` /
``remove_service`` are churn events on the session: the previous embedding
is carried through ``power.warm_state`` and only the churned service's VMs
are re-placed by ``solvers.resolve_incremental`` -- a periodic
full-portfolio defrag (masked by the same spec) bounds the drift of local
re-optimization.  Per-service ``Placement.power_w`` is attributed from the
per-node breakdown via each service's placed nodes and traversed routes
(``CFNSession.attribute``), so tenant numbers sum to the fleet total.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core import api as cfn_api
from ..core import embed as cfn_embed
from ..core import vsr as cfn_vsr
from ..core.power import Device
from ..core.topology import CFNTopology
from ..models.config import ArchConfig


@dataclass
class Service:
    name: str
    arch: ArchConfig
    tokens_per_s: float
    n_stages: int = 4
    source_node: int = 0
    priority: int = 0   # admission class, 0 = highest (spec.priority_classes)


@dataclass
class Placement:
    service: str
    stage_nodes: List[str]
    layers: List[str]
    power_w: float


class EnergyAwareScheduler:
    def __init__(self, topo: CFNTopology, method: str = "cfn-milp",
                 defrag_every: int = 16, max_hops: Optional[int] = None,
                 admit_power_budget_w: Optional[float] = None,
                 spec: Optional[cfn_api.PlacementSpec] = None,
                 session=None, monitor=None, telemetry=None,
                 device: Device = None):
        """``session`` (optional) supplies a pre-built placement session --
        a ``CFNSession`` or any session with its interface; otherwise a
        flat session is built from ``spec`` (or the legacy kwargs) on
        ``device`` (``None``: the CUDA card).  ``monitor`` (a
        ``fault.PlacementMonitor``) receives admission rejections and
        budget violations; ``telemetry`` (a ``telemetry.Telemetry``)
        receives spans, the energy ledger and the attribution from the
        underlying session."""
        if spec is None:
            spec = cfn_api.PlacementSpec(
                method=method, defrag_every=defrag_every, max_hops=max_hops,
                power_budget_w=admit_power_budget_w)
        self.topo = topo
        if session is not None:
            if monitor is not None:
                session.attach_monitor(monitor)
            if telemetry is not None:
                session.attach_telemetry(telemetry)
            self.session = session
        else:
            self.session = cfn_api.CFNSession(topo, spec, monitor=monitor,
                                              telemetry=telemetry,
                                              device=device)
        self.services: List[Service] = []
        self.rejected: List[str] = []   # names refused by admission control
        self.queued: List[str] = []     # names parked in the priority queue
        self._by_sid: Dict[int, Service] = {}
        self._queued_by_sid: Dict[int, Service] = {}

    @property
    def spec(self) -> cfn_api.PlacementSpec:
        return self.session.spec

    @property
    def method(self) -> str:
        return self.session.spec.method

    # -- churn events ------------------------------------------------------
    def add_service(self, svc: Service) -> List[Placement]:
        """Admit a service: one incremental re-embedding event.  Names key
        the removal API, so they must be unique among live services.  With
        SLA admission control configured (spec.max_hops / power budget), a
        refused service is recorded in ``self.rejected`` and the fleet
        placement is returned unchanged."""
        if any(s.name == svc.name for s in self.services):
            raise ValueError(f"service named {svc.name!r} is already live")
        vs = self._to_vsr(svc)
        before = self._session_queued_sids()
        if self.session.add(vs, priority=svc.priority) is None:
            fresh = [s for s in self._session_queued_sids() - before
                     if s not in self._by_sid]
            if fresh:   # parked, not refused: keeps its sid in the queue
                sid = max(fresh)
                self.queued.append(svc.name)
                self._queued_by_sid[sid] = svc
            else:
                self.rejected.append(svc.name)
            self._adopt_drained()
            return self.placements()
        self.services.append(svc)
        self._by_sid[self.session.sids[-1]] = svc
        self._adopt_drained()
        return self.placements()

    def add_services(self, svcs: List[Service]) -> List[Placement]:
        """Admit a BATCH of services as one churn wave
        (``session.apply_wave``): one fused re-solve + single polish pass
        instead of one per service, with admission decided per service in
        priority order.  Refused names land in ``self.rejected``, parked
        ones (``spec.queue_rejected``) in ``self.queued``."""
        for svc in svcs:
            if any(s.name == svc.name for s in self.services):
                raise ValueError(
                    f"service named {svc.name!r} is already live")
        names = [s.name for s in svcs]
        if len(names) != len(set(names)):
            raise ValueError("duplicate service name in batch")
        wres = self.session.apply_wave(
            [(self._to_vsr(s), None, s.priority) for s in svcs])
        by_sid = dict(zip(wres.sids, svcs))
        for sid in wres.admitted:
            self.services.append(by_sid[sid])
            self._by_sid[sid] = by_sid[sid]
        self.rejected.extend(by_sid[sid].name for sid in wres.rejected)
        # a queued service keeps its sid while parked and re-enters the
        # fleet under it when capacity frees (see _adopt_drained)
        for sid in wres.queued:
            self.queued.append(by_sid[sid].name)
            self._queued_by_sid[sid] = by_sid[sid]
        self._adopt_drained()
        return self.placements()

    def remove_service(self, name: str) -> List[Placement]:
        """Retire a service by name: detach + survivor re-pack."""
        sid = next((s for s, svc in self._by_sid.items()
                    if svc.name == name), None)
        if sid is None:
            raise KeyError(f"no service named {name!r}")
        self.session.remove(sid)
        svc = self._by_sid.pop(sid)
        self.services.remove(svc)    # by identity: exactly this admission
        self._adopt_drained()
        return self.placements()

    def remove_services(self, names: List[str]) -> List[Placement]:
        """Retire a BATCH of services as one departure wave: one fused
        ``detach_vsrs`` + one survivor re-settle, then the freed capacity
        drains the priority queue."""
        sids = []
        for name in names:
            sid = next((s for s, svc in self._by_sid.items()
                        if svc.name == name), None)
            if sid is None:
                raise KeyError(f"no service named {name!r}")
            sids.append(sid)
        self.session.apply_wave(departures=sids)
        for sid in sids:
            svc = self._by_sid.pop(sid)
            self.services.remove(svc)
        self._adopt_drained()
        return self.placements()

    def _to_vsr(self, svc: Service) -> cfn_vsr.VSRBatch:
        return cfn_vsr.from_architecture(
            svc.arch, tokens_per_s=svc.tokens_per_s, n_stages=svc.n_stages,
            source_node=svc.source_node)

    def _adopt_drained(self) -> None:
        """Reconcile queue churn with the session.  A parked service keeps
        its sid in the session's priority queue, so when freed capacity
        re-admits it the same sid shows up live -- move it queued -> live.
        Symmetrically, a live service preempted by a higher class
        (``spec.preempt``) moves live -> queued."""
        for sid in self.session.sids:
            svc = self._queued_by_sid.pop(sid, None)
            if svc is not None:
                self.services.append(svc)
                self._by_sid[sid] = svc
                self.queued.remove(svc.name)
        live = set(self.session.sids)
        gone = [s for s in self._by_sid if s not in live]
        if gone:
            parked = self._session_queued_sids()
            for sid in gone:
                if sid in parked:
                    svc = self._by_sid.pop(sid)
                    self.services.remove(svc)
                    self._queued_by_sid[sid] = svc
                    self.queued.append(svc.name)

    def _session_queued_sids(self) -> set:
        """Parked sids: a flat session's engine queue, or a federated
        session's region queues and fault queue."""
        eng = getattr(self.session, "engine", None)
        if eng is not None:   # flat CFNSession
            return set(eng.queued_sids)
        return set(self.session.queued_sids)

    def defrag(self) -> List[Placement]:
        """Force a full-portfolio re-pack of the current fleet (the spec's
        constraint masks apply -- hop-bounded services stay in radius)."""
        self.session.defrag()
        return self.placements()

    # -- reporting ---------------------------------------------------------
    def placements(self) -> List[Placement]:
        X = self.session.X
        if X is None:
            return []
        per_w = self.session.attribute()
        placements = []
        for row, sid in enumerate(self.session.sids):
            svc = self._by_sid.get(sid)
            if svc is None:   # admitted outside this facade (raw session)
                continue
            V = self.session.service_vms(row)   # rest is bucket/concat pad
            nodes = [self.topo.proc_names[p] for p in X[row][:V]]
            layers = [self.topo.proc_layer[p] for p in X[row][:V]]
            placements.append(Placement(
                service=svc.name, stage_nodes=nodes, layers=layers,
                power_w=per_w[sid]))
        return placements

    def solve(self) -> List[Placement]:
        """Kept for the one-shot API: returns the current placements (the
        session re-solves eagerly on every churn event)."""
        return self.placements()

    def total_power_w(self) -> float:
        return self.session.power_w()

    def savings_vs_cloud(self) -> Dict[str, float]:
        """The live fleet's saving vs the CDC baseline, both solved with
        ``method`` on an unpadded problem on the session's device."""
        vsrs = cfn_vsr.concat_all([self._to_vsr(s) for s in self.services])
        return {k: v for k, v in cfn_embed.savings_vs_baseline(
            self.topo, vsrs, baseline="cdc", method=self.method,
            device=self.session.device).items()
            if isinstance(v, float)}
