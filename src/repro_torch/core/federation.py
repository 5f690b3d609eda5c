"""Federated fog regions: the hierarchical multi-region CFN (torch).

The paper's CFN is one PON/metro tree hanging off one CDC; its stated
future work is a FEDERATION -- several fog regions, each a full Fig.-1
fabric, joined over a shared IP/WDM core.  This module is the second level
of the embedding hierarchy -- service -> region -> node -- over the solvers
and the online engine underneath, as in the JAX package:

  * **RegionPartition** maps a merged substrate (``topology.federated_scale``
    or any topology whose node names carry ``r{g}_`` prefixes) into
    per-region sub-substrates, each with its own route table (validated
    against the merged one at construction), plus an inter-region
    core-hop table over the unprefixed ``nsf*`` core.  For the batched
    solve it pads every region onto ONE (P, N, K) shape bucket, built once
    per device; pad nodes carry deterrent parameters and are masked out of
    every solver move.
  * **solve_portfolio_batched** runs the G regional portfolios in LOCKSTEP:
    every coordinate-sweep position is one ``torch.func.vmap``-ed
    ``delta_sweep`` + masked argmin + ``apply_move`` over the stacked
    [G, ...] problems, and every Metropolis step one vmapped chain step,
    so the number of delta-engine calls (and CUDA launches) does not grow
    with G.  ``_solve_regions_loop`` is its plain version: a Python loop
    over the regions through the single-problem functions.
  * **FederatedSession** is the facade: ``solve(vsrs)`` assigns each
    service a region (its source's home region, overridden by
    ``PlacementSpec.region_affinity`` / ``region_anti_affinity``), solves
    the regions at once, prices inter-region traffic exactly
    (``federated_breakdown``) and migrates services off regions over their
    ``region_power_budget_w``, then seeds one ``dynamic.OnlineEmbedder``
    per region.  ``add`` / ``remove`` / ``apply_wave`` are region-aware
    churn on those engines; ``fail_region`` / ``recover_region`` /
    ``brownout_region`` fault whole regions.
  * **Cross-region services** keep their pinned input VM at the physical
    source: the home region carries a *stub* (the input VM's compute), the
    host region the *body* (the free VMs, the pin re-anchored at the host
    region's CDC), and the *cut links* between them are priced along the
    merged route -- home egress, shared core, host ingress.
  * **Exactness**: ``federated_breakdown`` assembles merged float64 loads
    from the regional states plus the cut links; regional + inter-region
    watts sum to the total by construction, and the total is the float64
    oracle's of the equivalent flat placement.  A one-region federation
    delegates to the flat ``CFNSession``, so it is the flat session.

Admission rejections, regional budget breaches, migrations, region faults
and strands go to a ``fault.PlacementMonitor`` when one is attached; with
a ``telemetry.Telemetry`` the coordinator's calls are spanned and each
takes one fleet-exact energy-ledger sample (regions plus ``inter_region``
equal to the total).
"""
from __future__ import annotations

import dataclasses
import functools
import re
from dataclasses import dataclass, field, fields
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as _pytree
from torch.func import vmap

from . import dynamic, power, solvers
from . import vsr as vsr_mod
from .power import Device, resolve_device
from .topology import CFNTopology

__all__ = ["Region", "RegionPartition", "ServicePlan", "FederatedBreakdown",
           "FederatedResult", "FederatedSession", "federated_breakdown",
           "solve_portfolio_batched", "stack_problems", "stack_auxes"]

_REGION_RE = re.compile(r"^r(\d+)_")


def _region_tag(name: str) -> int:
    m = _REGION_RE.match(name)
    return int(m.group(1)) if m else -1


# ---------------------------------------------------------------------------
# The partition: merged substrate -> per-region substrates + core table
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Region:
    """One fog region of the federation (a dense local index space)."""

    index: int                 # dense federation index in [0, G)
    name: str
    topo: CFNTopology          # the region's own finalized sub-topology
    proc_ids: np.ndarray       # [P_r] merged proc index of local proc p
    net_ids: np.ndarray        # [N_r] merged net index of local net n

    @property
    def P(self) -> int:
        return len(self.proc_ids)

    @property
    def N(self) -> int:
        return len(self.net_ids)

    @property
    def pin_node(self) -> int:
        """Local node a migrated service's input VM is re-anchored at: the
        region's CDC, falling back to local node 0.  The pin carries zero
        demand and no links, so only a scalar ``max_hops`` reads it (a
        migrated body stays within that radius of the region's cloud)."""
        cdc = self.topo.layer_indices("cdc")
        return cdc[0] if cdc else 0


# pad-node parameters of the uniform shape bucket: a VM is never placed on a
# pad node (masked out of every solver move), a pad node with zero load
# draws exactly zero watts, and the deterrent E / zero NS make a stray
# placement catastrophic rather than silently cheap
_PAD_PROC = dict(E=1.0e6, C_pr=1.0, NS=0.0, pi_pr=0.0, pue_pr=1.0,
                 EL=0.0, C_lan=1.0e9, pi_lan=0.0, lan_share=0.0)
_PAD_NET = dict(eps=0.0, C_net=1.0e9, pi_net=0.0, pue_net=1.0,
                idle_share=0.0)


class RegionPartition:
    """Maps a merged CFN substrate into federated per-region substrates.

    Region membership is parsed from the ``r{g}_`` node-name prefixes that
    ``topology.federated_scale`` emits; unprefixed network nodes form the
    shared inter-region core.  A topology with no prefixes at all is a
    single-region federation (``RegionPartition.single``): the one region
    IS the merged substrate.  Everything here is host numpy except
    ``padded_substrates``, which puts the padded regional tables on a
    device; the merged route table stays on the host (only
    ``federated_breakdown`` and the closure check read it).
    """

    def __init__(self, topo: CFNTopology, regions: List[Region],
                 proc_region: np.ndarray, net_region: np.ndarray):
        self.topo = topo
        self.regions = regions
        self.proc_region = np.asarray(proc_region)
        self.net_region = np.asarray(net_region)
        self.core_net_ids = np.nonzero(self.net_region < 0)[0]
        # merged proc id -> region-local proc id
        self._proc_local = np.full(topo.P, -1, np.int64)
        for reg in regions:
            self._proc_local[reg.proc_ids] = np.arange(reg.P)
        self.core_hops = self._core_hop_table()
        self._padded_np: Optional[tuple] = None
        self._padded_dev: Dict[str, list] = {}

    # -- construction -----------------------------------------------------
    @classmethod
    def from_topology(cls, topo: CFNTopology) -> "RegionPartition":
        pr = np.array([_region_tag(n) for n in topo.proc_names])
        nr = np.array([_region_tag(n) for n in topo.net_names])
        if (pr < 0).all():
            return cls.single(topo)
        if (pr < 0).any():
            bad = [n for n, g in zip(topo.proc_names, pr) if g < 0]
            raise ValueError(f"processing nodes without an r<g>_ region "
                             f"prefix: {bad[:5]}")
        tags = sorted(set(pr.tolist()))
        regions: List[Region] = []
        proc_region = np.zeros(topo.P, np.int64)
        net_region = np.full(topo.N, -1, np.int64)
        for i, g in enumerate(tags):
            proc_ids = np.nonzero(pr == g)[0]
            net_ids = np.nonzero(nr == g)[0]
            proc_region[proc_ids] = i
            net_region[net_ids] = i
            sub = CFNTopology()
            names = set()
            for p in proc_ids:
                sub.add_proc(topo.proc_names[p], topo.proc_hw[p],
                             topo.proc_layer[p])
                names.add(topo.proc_names[p])
            for n in net_ids:
                sub.add_net(topo.net_names[n], topo.net_hw[n])
                names.add(topo.net_names[n])
            for a, b in topo.edges:
                if a in names and b in names:
                    sub.connect(a, b)
            sub.finalize()
            # closure guard: every merged intra-region route stays on the
            # region's network nodes with the hop count the region's own
            # router finds (the tree-behind-one-attachment property the
            # decomposition rests on)
            rt = np.asarray(topo.route_idx)[np.ix_(proc_ids, proc_ids)]
            real = rt[rt < topo.N]
            if real.size and not np.all(net_region[real] == i):
                raise ValueError(
                    f"region r{g} is not closed: an intra-region route "
                    "traverses out-of-region network nodes")
            if not np.array_equal(
                    np.asarray(sub.route_len),
                    np.asarray(topo.route_len)[np.ix_(proc_ids, proc_ids)]):
                raise ValueError(f"region r{g} sub-routes disagree with the "
                                 "merged route table")
            regions.append(Region(i, f"r{g}", sub, proc_ids, net_ids))
        return cls(topo, regions, proc_region, net_region)

    @classmethod
    def single(cls, topo: CFNTopology) -> "RegionPartition":
        """The identity partition: one region whose sub-topology IS the
        merged topology (index spaces untouched, no padding) -- the
        1-region-federation == flat-session contract."""
        reg = Region(0, "all", topo, np.arange(topo.P), np.arange(topo.N))
        return cls(topo, [reg], np.zeros(topo.P, np.int64),
                   np.zeros(topo.N, np.int64))

    # -- introspection ----------------------------------------------------
    @property
    def G(self) -> int:
        return len(self.regions)

    def local_proc(self, merged_id: int) -> int:
        return int(self._proc_local[merged_id])

    def home_region(self, merged_proc_id: int) -> int:
        return int(self.proc_region[merged_proc_id])

    def _core_hop_table(self) -> np.ndarray:
        """[G, G] shared-core hops between region pairs: how many core
        (unassigned) network nodes the merged route between the two regions
        traverses."""
        G = self.G
        out = np.zeros((G, G), np.int64)
        rt = np.asarray(self.topo.route_idx)
        for a in range(G):
            for b in range(G):
                if a == b:
                    continue
                ids = rt[self.regions[a].proc_ids[0],
                         self.regions[b].proc_ids[0]]
                ids = ids[ids < self.topo.N]
                out[a, b] = int((self.net_region[ids] < 0).sum())
        return out

    # -- the uniform shape bucket (batched solving) ------------------------
    def padded_arrays(self):
        """The per-region substrate arrays on ONE (P_pad, N_pad, K_pad)
        bucket as host numpy -- parameters, ``route_idx`` (sentinel
        N_pad) and, while P_pad <= ``power.DENSE_ROUTE_MAX_P``, the dense
        ``route_dense`` rows -- plus the per-region real-node masks.
        Returns ``(arrays, real_masks, (P_pad, N_pad, K_pad))``; cached
        (the partition is immutable)."""
        if self._padded_np is not None:
            return self._padded_np
        P_pad = max(r.P for r in self.regions)
        N_pad = max(r.N for r in self.regions)
        K_pad = max(r.topo.K for r in self.regions)
        subs, masks = [], []
        for reg in self.regions:
            d: Dict[str, Optional[np.ndarray]] = {}
            for k, v in reg.topo.proc_param_arrays().items():
                d[k] = np.concatenate(
                    [v, np.full(P_pad - reg.P, _PAD_PROC[k], np.float32)])
            for k, v in reg.topo.net_param_arrays().items():
                d[k] = np.concatenate(
                    [v, np.full(N_pad - reg.N, _PAD_NET[k], np.float32)])
            rt = np.full((P_pad, P_pad, K_pad), N_pad, np.int32)
            r0 = np.asarray(reg.topo.route_idx)
            rt[:reg.P, :reg.P, :r0.shape[2]] = np.where(r0 == reg.N, N_pad,
                                                        r0)
            d["route_idx"] = rt
            d["route_dense"] = None
            if P_pad <= power.DENSE_ROUTE_MAX_P:
                dense = np.zeros((P_pad * P_pad, N_pad + 1), np.float32)
                bb, ee, _ = np.indices(rt.shape)
                dense[(bb * P_pad + ee).reshape(-1), rt.reshape(-1)] = 1.0
                d["route_dense"] = dense[:, :N_pad]
            subs.append(d)
            m = np.zeros(P_pad, bool)
            m[:reg.P] = True
            masks.append(m)
        self._padded_np = (subs, masks, (P_pad, N_pad, K_pad))
        return self._padded_np

    def padded_substrates(self, device: Device = None):
        """``padded_arrays`` as ``power.build_problem`` substrate dicts of
        tensors on ``device`` (``None``: the CUDA card), built once per
        device.  Returns ``(substrates, real_masks, (P_pad, N_pad,
        K_pad))``."""
        dev = resolve_device(device)
        arrays, masks, shape = self.padded_arrays()
        key = str(dev)
        if key not in self._padded_dev:
            self._padded_dev[key] = [
                {k: None if v is None else torch.as_tensor(v, device=dev)
                 for k, v in d.items()} for d in arrays]
        return self._padded_dev[key], masks, shape


# ---------------------------------------------------------------------------
# Service plans: the service -> region level of the hierarchy
# ---------------------------------------------------------------------------

@dataclass
class ServicePlan:
    """Where one service lives in the federation.

    ``body`` is the region-local VSR hosted in ``assigned`` (source index
    localized); for a cross-region service ``stub`` carries the pinned
    input VM's compute in ``home`` and ``cuts`` lists the severed virtual
    links ``(h_mbps, vm_col, input_is_src)``, priced along the merged
    home <-> host route."""

    sid: int
    home: int
    assigned: int
    vsr: vsr_mod.VSRBatch
    body: vsr_mod.VSRBatch
    stub: Optional[vsr_mod.VSRBatch] = None
    cuts: List[Tuple[float, int, bool]] = field(default_factory=list)
    body_row: int = -1
    stub_row: int = -1

    @property
    def migrated(self) -> bool:
        return self.stub is not None


def make_plan(partition: RegionPartition, service: vsr_mod.VSRBatch,
              sid: int, assigned: int) -> ServicePlan:
    """Split one R=1 service (merged source index) into its regional
    parts."""
    if service.R != 1:
        raise ValueError(f"services are R=1, got R={service.R}")
    src_m = int(service.src[0])
    home = partition.home_region(src_m)
    src_local = partition.local_proc(src_m)
    iv = int(service.input_vm[0])
    if assigned == home:
        body = vsr_mod.VSRBatch(
            F=service.F.copy(), H=service.H.copy(),
            src=np.array([src_local], np.int32),
            input_vm=service.input_vm.copy())
        return ServicePlan(sid=sid, home=home, assigned=assigned,
                           vsr=service, body=body)
    F = service.F.copy()
    H = service.H.copy()
    cuts: List[Tuple[float, int, bool]] = []
    self_h = float(H[0, iv, iv])
    H[0, iv, iv] = 0.0
    for d in range(service.V):
        if d == iv:
            continue
        if H[0, iv, d] > 0:
            cuts.append((float(H[0, iv, d]), d, True))
            H[0, iv, d] = 0.0
        if H[0, d, iv] > 0:
            cuts.append((float(H[0, d, iv]), d, False))
            H[0, d, iv] = 0.0
    F_in = float(F[0, iv])
    F[0, iv] = 0.0
    host = partition.regions[assigned]
    body = vsr_mod.VSRBatch(
        F=F, H=H, src=np.array([host.pin_node], np.int32),
        input_vm=service.input_vm.copy())
    stub_H = np.zeros((1, 2, 2), np.float32)
    stub_H[0, 0, 0] = self_h
    stub = vsr_mod.VSRBatch(
        F=np.array([[F_in, 0.0]], np.float32), H=stub_H,
        src=np.array([src_local], np.int32),
        input_vm=np.zeros(1, np.int32))
    return ServicePlan(sid=sid, home=home, assigned=assigned, vsr=service,
                       body=body, stub=stub, cuts=cuts)


def _placeholder_service() -> vsr_mod.VSRBatch:
    """A zero service for a region with no workload: pinned input at local
    node 0, one free zero-demand VM (so the padded problem keeps a free
    position), no links -- contributes exactly nothing."""
    return vsr_mod.VSRBatch(F=np.zeros((1, 2), np.float32),
                            H=np.zeros((1, 2, 2), np.float32),
                            src=np.zeros(1, np.int32),
                            input_vm=np.zeros(1, np.int32))


# ---------------------------------------------------------------------------
# Exact federated power accounting (float64, per merged node, host numpy)
# ---------------------------------------------------------------------------

class FederatedBreakdown(NamedTuple):
    total_w: float             # fleet watts (regional + inter-region)
    regional_w: np.ndarray     # [G] watts on each region's proc+net nodes
    inter_region_w: float      # Eq.(1) watts on the shared core
    violation: float           # merged capacity-violation magnitude
    per_proc_w: np.ndarray     # [P_merged]
    per_net_w: np.ndarray      # [N_merged]

    @property
    def objective(self) -> float:
        return self.total_w + power.PENALTY * self.violation


def _loads_f64(problem: power.PlacementProblem, X: np.ndarray):
    """(omega[P], theta[P], lam[N]) of a whole placement at float64 -- the
    accumulation ``power._loads`` performs, on the problem's host arrays
    (``PlacementProblem.host``: no device tensor is read)."""
    h = problem.host
    X = np.where(h.fixed_mask, h.fixed_node, np.asarray(X))
    Xf = X.reshape(-1)
    N = problem.N
    omega = np.zeros(problem.P, np.float64)  # tracelint: allow[CFN102]
    theta = np.zeros(problem.P, np.float64)  # tracelint: allow[CFN102]
    lam = np.zeros(N, np.float64)  # tracelint: allow[CFN102]
    np.add.at(omega, Xf, np.asarray(h.F, np.float64).reshape(-1))  # tracelint: allow[CFN102]
    rt = h.route_idx
    for s, d, hh in zip(h.link_src, h.link_dst,
                        np.asarray(h.link_h, np.float64)):  # tracelint: allow[CFN102]
        b, e = int(Xf[s]), int(Xf[d])
        theta[b] += hh
        if e != b:
            theta[e] += hh
            ids = rt[b, e]
            lam[ids[ids < N]] += hh
    return omega, theta, lam


def federated_breakdown(partition: RegionPartition,
                        region_states: Sequence[Tuple[int,
                                                      power.PlacementProblem,
                                                      np.ndarray]],
                        cuts: Sequence[Tuple[float, int, int, bool]] = (),
                        ) -> FederatedBreakdown:
    """Exact fleet power: merged-substrate float64 loads assembled from the
    per-region states plus the inter-region cut links, evaluated per node.

    ``region_states``: ``(region_index, regional_problem, X_local)`` per
    live region (padded problems allowed -- pad nodes must carry zero
    load).  ``cuts``: ``(h_mbps, src_merged, dst_merged, src_is_input)``
    per severed cross-region virtual link, accumulated along the merged
    route (home egress + shared core + host ingress).  Regional +
    inter-region watts sum to ``total_w`` by construction; the total is
    the float64 oracle's of the merged placement."""
    from ..kernels.ref import eq_terms_f64
    topo = partition.topo
    P, N = topo.P, topo.N
    omega = np.zeros(P, np.float64)  # tracelint: allow[CFN102]
    theta = np.zeros(P, np.float64)  # tracelint: allow[CFN102]
    lam = np.zeros(N, np.float64)  # tracelint: allow[CFN102]
    for g, prob, X in region_states:
        reg = partition.regions[g]
        om, th, lm = _loads_f64(prob, X)
        if (np.abs(om[reg.P:]).max(initial=0.0) > 0
                or np.abs(th[reg.P:]).max(initial=0.0) > 0
                or np.abs(lm[reg.N:]).max(initial=0.0) > 0):
            raise ValueError(f"region {reg.name}: load on a pad node "
                             "(placement escaped the real-node mask)")
        omega[reg.proc_ids] += om[:reg.P]
        theta[reg.proc_ids] += th[:reg.P]
        lam[reg.net_ids] += lm[:reg.N]
    rt = np.asarray(topo.route_idx)
    for h, src_m, dst_m, src_is_input in cuts:
        b, e = (src_m, dst_m) if src_is_input else (dst_m, src_m)
        theta[b] += h
        if e != b:
            theta[e] += h
            ids = rt[b, e]
            lam[ids[ids < N]] += h
    per_net, per_proc, violation = eq_terms_f64(
        topo.proc_param_arrays(), topo.net_param_arrays(), omega, theta,
        lam)
    regional = np.zeros(partition.G, np.float64)  # tracelint: allow[CFN102]
    for reg in partition.regions:
        regional[reg.index] = (per_proc[reg.proc_ids].sum()
                               + per_net[reg.net_ids].sum())
    inter = float(per_net[partition.core_net_ids].sum())
    return FederatedBreakdown(
        total_w=float(per_proc.sum() + per_net.sum()),
        regional_w=regional, inter_region_w=inter,
        violation=float(violation), per_proc_w=per_proc, per_net_w=per_net)


# ---------------------------------------------------------------------------
# The region-batched portfolio: stacked problems, one lockstep program
# ---------------------------------------------------------------------------
#
# The partition pads every region onto ONE shape bucket (P/N/K, and
# R/V/L/D/M below), so the G regional portfolios run as one program over a
# leading region axis: warm-start init, coordinate sweeps and the
# Metropolis delta scan are the single-problem delta-engine functions
# (``solvers._sweep_step``, ``solvers._anneal_scan_delta``) lifted with
# ``torch.func.vmap``.  Each sweep position is then one vmapped call for all
# regions, so the host issues the same kernels a flat sweep position does
# (each over [G, ...]) and the call count does not grow with G.


def _pad_links(problem: power.PlacementProblem,
               L: int) -> power.PlacementProblem:
    """Widen the virtual-link tensors to length ``L`` with zero-bitrate
    self-loops: a 0-Mbps link adds exactly nothing to any load or delta,
    so padded problems evaluate identically (stacking needs one L).  Pad
    loops are spread round-robin over the flat VM space so no VM's
    incident degree D grows with the pad count."""
    d = L - int(problem.link_src.shape[0])
    if d <= 0:
        return problem
    J = problem.R * problem.V
    ids = torch.arange(d, device=problem.device) % J
    ids = ids.to(problem.link_src.dtype)
    return dataclasses.replace(
        problem,
        link_src=torch.cat([problem.link_src, ids]),
        link_dst=torch.cat([problem.link_dst, ids]),
        link_h=torch.cat([problem.link_h,
                          problem.link_h.new_zeros(d)]))


def stack_problems(problems: Sequence[power.PlacementProblem]
                   ) -> power.PlacementProblem:
    """Stack same-shaped problems along a new leading (region) axis.

    Every field must share its shape across regions (the federation pads
    regions to one bucket and ``_pad_links`` evens the link counts);
    ``route_dense`` must be all-present or all-absent (the same P_pad
    implies that).  The stacked problem's ``P`` / ``N`` / ... properties
    read the region axis; it is meant for ``torch.func.vmap``."""
    kw = {}
    for f in fields(power.PlacementProblem):
        vals = [getattr(p, f.name) for p in problems]
        if all(v is None for v in vals):
            kw[f.name] = None
        elif any(v is None for v in vals):
            raise ValueError(f"stack_problems: {f.name} is present in some "
                             "problems only")
        else:
            kw[f.name] = torch.stack(vals)
    return power.PlacementProblem(**kw)


def _with_views(stacked: power.PlacementProblem) -> power.PlacementProblem:
    """Compute each region's int64 / packed views once, batched, into the
    stacked problem, so every vmapped call below carries them (see the
    pytree registration in ``core/power.py``)."""
    views = vmap(lambda p: tuple(getattr(p, k) for k in power._VIEWS))(
        stacked)
    stacked.__dict__.update(zip(power._VIEWS, views))
    return stacked


def stack_auxes(auxes: Sequence[power.PlacementAux],
                d_pad: Optional[int] = None,
                m_pad: Optional[int] = None) -> power.PlacementAux:
    """Stack per-problem auxes, padding the incident-link width D and the
    free-position count M to the fleet maxima (or the ``d_pad`` / ``m_pad``
    buckets).

    D padding appends no-op links (``other = self``, zero bitrate); M
    padding repeats each region's first free position -- a repeated sweep
    position is a harmless re-sweep (``solvers._pad_positions``).  Every
    region must have >= 1 free position (the federation guarantees it).
    The stacked aux lives on the first aux's device."""
    D = max(max(int(a.inc_h.shape[1]) for a in auxes), d_pad or 0)
    M = max(max(int(a.free_pos.shape[0]) for a in auxes), m_pad or 0)
    io, ih, isrc, fp, ff = [], [], [], [], []
    for a in auxes:
        J, d = a.inc_other.shape
        m = a.free_pos.shape[0]
        if m == 0:
            raise ValueError("stack_auxes: a stacked problem has no free "
                             "position (everything pinned)")
        n = lambda t: t.cpu().numpy()
        self_col = np.broadcast_to(np.arange(J, dtype=np.int32)[:, None],
                                   (J, D - d))
        io.append(np.concatenate([n(a.inc_other), self_col], 1))
        ih.append(np.concatenate(
            [n(a.inc_h), np.zeros((J, D - d), np.float32)], 1))
        isrc.append(np.concatenate(
            [n(a.inc_src), np.zeros((J, D - d), bool)], 1))
        pos = n(a.free_pos)
        fp.append(np.concatenate([pos, np.tile(pos[:1], (M - m, 1))]))
        flat = n(a.free_flat)
        ff.append(np.concatenate([flat, np.tile(flat[:1], M - m)]))
    dev = auxes[0].inc_h.device
    t = lambda x: torch.as_tensor(np.stack(x), device=dev)
    return power.PlacementAux(inc_other=t(io), inc_h=t(ih), inc_src=t(isrc),
                              free_pos=t(fp), free_flat=t(ff))


def _lockstep_move(problem, aux, state, r, v, eligible):
    return solvers._sweep_step(problem, aux, state, r, v, eligible)[0]


def _restart(problem, X_best, rand):
    """Chain 0 warm at the swept placement, the others at their random
    restarts [C, R, V], pins applied."""
    keep = (torch.arange(rand.shape[0], device=rand.device) == 0)
    return power.apply_pins(problem, torch.where(keep[:, None, None],
                                                 X_best[None], rand))


_init_states = vmap(power.init_state)
_lockstep = vmap(_lockstep_move)
_restarts = vmap(_restart)
_anneal_scans = vmap(solvers._anneal_scan_delta,
                     in_dims=(0, 0, 0, 0, 0, 0, None))
_objectives = vmap(power.objective)


@solvers.count_traces("solve_regions")
def _solve_regions(problems, auxes, X0, eligible, positions, rand_chains,
                   j_prop, p_prop, u_prop, temps, n_sweeps: int):
    """One lockstep program over the stacked region axis: init -> n_sweeps
    coordinate sweeps -> exact refresh -> (with proposals) the Metropolis
    delta scan, chain 0 warm -> exact re-score and best-of.

    Every input carries a leading [G] axis except ``temps`` [S];
    ``problems`` is ``stack_problems``' (views filled by ``_with_views``).
    Each sweep position is ONE vmapped ``solvers._sweep_step`` for all G
    regions, each Metropolis run ONE vmapped ``_anneal_scan_delta``.
    Returns ``(X [G, R, V], objective [G])`` tensors."""
    st = _init_states(problems, X0)
    for _ in range(n_sweeps):
        for k in range(positions.shape[1]):
            st = _lockstep(problems, auxes, st, positions[:, k, 0],
                           positions[:, k, 1], eligible)
    # exact refresh (kills float32 drift before the best-of compare)
    st = _init_states(problems, st.X)
    X_best, obj_best = st.X, st.obj
    if j_prop.shape[1] > 0:
        Xc = _restarts(problems, X_best, rand_chains)
        bX, _, _ = _anneal_scans(problems, auxes, Xc, j_prop, p_prop,
                                 u_prop, temps)
        bobj = _objectives(problems, bX)    # exact re-score
        better = bobj < obj_best
        X_best = torch.where(better[:, None, None], bX, X_best)
        obj_best = torch.where(better, bobj, obj_best)
    return X_best, obj_best


def _region(tree, g: int):
    """Region ``g``'s slice of a stacked pytree (problem, aux or state)."""
    leaves, spec = _pytree.tree_flatten(tree)
    return _pytree.tree_unflatten([x[g] for x in leaves], spec)


def _solve_regions_loop(problems, auxes, X0, eligible, positions,
                        rand_chains, j_prop, p_prop, u_prop, temps,
                        n_sweeps: int):
    """The plain version of ``_solve_regions``: the same inputs, one region
    at a time through the single-problem functions (``solvers._sweep``,
    ``solvers._anneal_scan_delta``) -- G times the calls."""
    Xs, objs = [], []
    for g in range(X0.shape[0]):
        prob, aux = _region(problems, g), _region(auxes, g)
        st = power.init_state(prob, X0[g])
        for _ in range(n_sweeps):
            st, _ = solvers._sweep(prob, aux, st, positions[g].cpu().numpy(),
                                   eligible[g])
        st = power.init_state(prob, st.X)
        X_best, obj_best = st.X, st.obj
        if j_prop.shape[1] > 0:
            Xc = _restart(prob, X_best, rand_chains[g])
            bX, _, _ = solvers._anneal_scan_delta(prob, aux, Xc, j_prop[g],
                                                  p_prop[g], u_prop[g], temps)
            bobj = power.objective(prob, bX)
            if bool(bobj < obj_best):
                X_best, obj_best = bX, bobj
        Xs.append(X_best)
        objs.append(obj_best)
    return torch.stack(Xs), torch.stack(objs)


# effort tier -> (coordinate sweeps, Metropolis steps, chains) per region
_BATCH_EFFORT = {"quick": (2, 0, 0), "standard": (2, 2000, 8),
                 "high": (3, 6000, 16)}


def _batch_inputs(problems: Sequence[power.PlacementProblem],
                  X0: Sequence[np.ndarray], eligible: Sequence[np.ndarray],
                  spec=None, gen: Optional[torch.Generator] = None,
                  streams: Optional[tuple] = None) -> tuple:
    """The arguments of ``_solve_regions`` / ``_solve_regions_loop`` for G
    same-bucket problems (see ``solve_portfolio_batched``)."""
    if not problems:
        raise ValueError("solve_portfolio_batched needs >= 1 problem")
    effort = getattr(spec, "effort", "standard")
    n_sweeps, n_steps, n_chains = _BATCH_EFFORT[effort]
    G = len(problems)
    R, V, P = problems[0].R, problems[0].V, problems[0].P
    dev = problems[0].device
    # bucket every workload-dependent shape (L links, D degree, M free
    # positions), as the JAX package does for its one compile: the padded
    # inputs, and so the results, are the reference's
    L = solvers._pow2(max(int(p.link_src.shape[0]) for p in problems))
    problems = [_pad_links(p, L) for p in problems]
    auxes = [power.build_aux(p) for p in problems]
    d_pad = solvers._pow2(max(int(a.inc_h.shape[1]) for a in auxes))
    m_pad = R * max(1, V - 1)
    stacked = _with_views(stack_problems(problems))
    aux_stacked = stack_auxes(auxes, d_pad=d_pad, m_pad=m_pad)
    el = torch.as_tensor(np.stack([np.asarray(e, bool) for e in eligible]),
                         device=dev)
    X0_t = torch.as_tensor(np.stack([np.asarray(x, np.int32) for x in X0]),
                           device=dev)
    n_ch = max(1, n_chains)
    if streams is not None:
        jp, pp_, up, rand = (power.to_tensor(np.asarray(s), dev)
                             for s in streams)
        jp, pp_, rand = jp.long(), pp_.to(torch.int32), rand.to(torch.int32)
        up = up.to(torch.float32)
    elif n_steps > 0:
        # per-region proposal streams and eligible restarts, drawn from
        # ``gen`` region by region in this order
        gen = solvers.default_generator() if gen is None else gen
        jps, pps, ups, rands = [], [], [], []
        for g, aux in enumerate(auxes):
            _, cnt, cand = solvers._eligible_np(eligible[g])
            fi, p_prop, u_prop = solvers._anneal_proposals(
                gen, aux, n_steps, n_ch, P, V=V, cnt=cnt, cand=cand)
            jps.append(aux.free_flat[fi].long())
            pps.append(p_prop)
            ups.append(u_prop)
            u_r = torch.rand((n_ch, R, V), generator=gen).to(dev)
            rands.append(solvers._sample_eligible(
                u_r, torch.arange(R, device=dev)[None, :, None],
                torch.as_tensor(cnt, device=dev),
                torch.as_tensor(cand, device=dev)).to(torch.int32))
        jp, pp_, up, rand = (torch.stack(x) for x in (jps, pps, ups, rands))
    else:       # no anneal: the streams are dead
        jp = torch.zeros((G, 0, n_ch), dtype=torch.long, device=dev)
        pp_ = torch.zeros((G, 0, n_ch), dtype=torch.int32, device=dev)
        up = torch.zeros((G, 0, n_ch), device=dev)
        rand = torch.zeros((G, n_ch, R, V), dtype=torch.int32, device=dev)
    # the JAX package's schedule: float64 on the host, then float32
    temps = torch.as_tensor(
        50.0 * (0.05 / 50.0) ** (np.arange(max(1, n_steps))
                                 / max(1, n_steps - 1)),
        dtype=torch.float32, device=dev)
    return (stacked, aux_stacked, X0_t, el, aux_stacked.free_pos, rand, jp,
            pp_, up, temps, n_sweeps)


def solve_portfolio_batched(problems: Sequence[power.PlacementProblem],
                            X0: Sequence[np.ndarray],
                            eligible: Sequence[np.ndarray],
                            spec=None,
                            gen: Optional[torch.Generator] = None,
                            streams: Optional[tuple] = None,
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Solve G same-bucket placement problems in one lockstep program.

    The batched counterpart of ``solvers.solve_portfolio`` for federated
    fleets: per-region warm starts ``X0`` [G][R, V] are swept (effort
    "quick": 2 sweeps; "standard": 2 sweeps + a 2000-step x 8-chain delta
    anneal; "high": 3 + 6000 x 16) by the delta-engine primitives
    vectorized over the region axis (``_solve_regions``).  ``eligible``
    [G][R, P] bool is mandatory (at least the real-node mask).  Random
    draws come from ``gen`` (CPU, seed 0 when None): per region, in order,
    the proposals and the restart placements; ``streams`` injects
    ``(j_prop [G, T, C] flat VM indices, p_prop [G, T, C], u_prop
    [G, T, C], restarts [G, C, R, V])`` instead (the tests pass the JAX
    package's draws).  Returns ``(X [G, R, V], objective [G])`` as numpy.
    """
    X, obj = _solve_regions(*_batch_inputs(problems, X0, eligible, spec,
                                           gen, streams))
    return X.cpu().numpy(), obj.cpu().numpy()


# ---------------------------------------------------------------------------
# The federation facade
# ---------------------------------------------------------------------------

class FederatedResult(NamedTuple):
    X: np.ndarray              # [R, V] merged placement, original row order
    breakdown: FederatedBreakdown
    assignments: np.ndarray    # [R] region index per service
    region_obj: np.ndarray     # [G] per-region solver objectives
    migrations: int            # coordinator migrations performed

    @property
    def objective(self) -> float:
        return self.breakdown.objective

    @property
    def power(self) -> float:
        return self.breakdown.total_w


def _traced(name: str, ledger: bool = False):
    """Span a ``FederatedSession`` coordinator method when telemetry is
    attached (multi-region only -- the flat path delegates to a flat
    session whose engine records its own spans); ``ledger=True``
    additionally takes one fleet-exact energy sample after the call.
    The no-telemetry path stays a plain call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            tel = self.telemetry
            if tel is None or self._flat is not None:
                return fn(self, *args, **kwargs)
            with tel.span(name):
                out = fn(self, *args, **kwargs)
            if ledger:
                self._record_fleet_energy(name)
            return out
        return wrapper
    return deco


class FederatedSession:
    """Hierarchical multi-region placement: one facade over G regions.

    ``solve(vsrs)`` is the batch path: assign services to regions, solve
    every region's portfolio at once (``solve_portfolio_batched``), then
    run the coordinator -- exact federated accounting, inter-region
    pricing, cross-region migration on regional ``region_power_budget_w``
    breaches -- and seed the per-region online engines from the result.
    ``add`` / ``remove`` / ``apply_wave`` are region-aware churn on those
    engines; an arrival that pushes its region over budget is migrated to
    the coolest admissible region (``region_anti_affinity`` and
    ``inter_region_hops`` respected), every breach, migration and
    rejection counted on the attached ``fault.PlacementMonitor``.

    A single-region federation (a topology with no ``r{g}_`` prefixes, or
    ``RegionPartition.single``) delegates wholesale to the flat
    ``CFNSession``: placements and float64 power are the flat path's.

    ``device=None`` means the CUDA card (and raises without one); random
    draws come from ``generator`` (a CPU ``torch.Generator``, seed 1 by
    default): each region engine and each batched solve gets a generator
    seeded from it.  ``telemetry`` (a ``telemetry.Telemetry``): see
    ``attach_telemetry``.
    """

    MAX_COORD_PASSES = 4

    def __init__(self, topo, spec=None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None, monitor=None,
                 partition: Optional[RegionPartition] = None,
                 telemetry=None):
        from . import api as api_mod
        if partition is None:
            partition = (topo if isinstance(topo, RegionPartition)
                         else RegionPartition.from_topology(topo))
        self.partition = partition
        self.topo = partition.topo
        self.spec = spec if spec is not None else api_mod.PlacementSpec()
        self.device = resolve_device(device)
        self.monitor = monitor
        self._gen = (solvers.default_generator(1) if generator is None
                     else generator)
        self._plans: Dict[int, ServicePlan] = {}
        self._order: List[int] = []
        self._engines: Dict[int, dynamic.OnlineEmbedder] = {}
        self._next_sid = 0
        self._last_result: Optional[FederatedResult] = None
        # fault plane: down regions, brownout budget overrides, stranded
        # services parked for retry-on-recovery, and the session clock
        self._down: set = set()
        self._budget_override: Dict[int, float] = {}
        self._fqueue: List[Tuple[vsr_mod.VSRBatch, int, int]] = []
        self._prio: Dict[int, int] = {}
        self._now = 0.0
        self._region_monitors: Dict[int, object] = {}
        self._flat = None
        if partition.G == 1:
            self._flat = api_mod.CFNSession(self.topo, self.spec,
                                            generator=self._gen,
                                            device=self.device)
            self._flat.engine.monitor = monitor
        else:
            self._check_spec_supported()
        self.telemetry = None
        if telemetry is not None:
            self.attach_telemetry(telemetry)

    # -- config helpers ---------------------------------------------------
    def attach_monitor(self, monitor) -> None:
        """Attach (or replace) the ``fault.PlacementMonitor`` receiving this
        federation's breach / migration / admission events -- propagated
        to every live regional engine."""
        self.monitor = monitor
        if self._flat is not None:
            self._flat.attach_monitor(monitor)
        for eng in self._engines.values():
            eng.monitor = monitor
        if (monitor is not None and self.telemetry is not None
                and hasattr(monitor, "attach_telemetry")):
            monitor.attach_telemetry(self.telemetry)

    def attach_telemetry(self, telemetry) -> None:
        """Attach a ``telemetry.Telemetry`` to the federation.

        Single-region: delegates wholesale to the flat ``CFNSession`` --
        spans, convergence traces and the energy ledger come from its
        engine, as on the flat path.  Multi-region: the COORDINATOR is the
        instrumented layer -- spans around ``solve`` / ``add`` / ``remove``
        / ``apply_wave`` / ``apply_fault``, one fleet-exact ledger sample
        (per-region watt splits from ``breakdown()``) after each, and the
        shape and launch attribution.  Region engines deliberately do NOT
        tick the shared ledger: their commit samples would carry regional
        (not fleet) totals and corrupt the fleet watt series."""
        self.telemetry = telemetry
        if telemetry is None:
            if self._flat is not None:
                self._flat.attach_telemetry(None)
            return
        if self._flat is not None:
            self._flat.attach_telemetry(telemetry)
            return
        if telemetry.ledger.tiers is None:
            from ..telemetry import tiers_of
            telemetry.ledger.set_tiers(tiers_of(self.topo))
        telemetry.attach_traces()
        if (self.monitor is not None
                and hasattr(self.monitor, "attach_telemetry")):
            self.monitor.attach_telemetry(telemetry)

    def _record_fleet_energy(self, event: str) -> None:
        """One fleet-exact ledger sample (multi-region path only): total,
        Eq.(1) networking and Eq.(2) processing watts with per-region
        splits, all from the exact ``federated_breakdown`` accounting."""
        tel = self.telemetry
        if tel is None or self._flat is not None:
            return
        try:
            bd = self.breakdown()
        except ValueError:   # empty session (everything departed/refused)
            return
        per_region = {int(g): float(w)
                      for g, w in enumerate(np.asarray(bd.regional_w))}
        # shared-core watts are in no region: keep the splits summing to
        # the exact fleet total
        per_region["inter_region"] = float(bd.inter_region_w)
        tel.ledger.tick(
            self._now, total_w=float(bd.total_w),
            net_w=float(np.asarray(bd.per_net_w).sum()),
            proc_w=float(np.asarray(bd.per_proc_w).sum()),
            per_region=per_region, event=event)
        tel.inc(f"commit.{event}")

    def _check_spec_supported(self) -> None:
        if self.spec.eligible is not None or (
                self.spec.max_hops is not None
                and np.ndim(self.spec.max_hops) > 0):
            raise ValueError(
                "multi-region federation supports scalar max_hops only "
                "(row-positional constraints cannot follow a service "
                "across regions); use region_affinity for placement "
                "steering")
        if self.spec.preempt:
            raise ValueError(
                "multi-region federation does not support preempt=True: "
                "a region engine preempting into its private queue would "
                "desync the federation's plan registry.  Preemption is a "
                "flat-session / per-region-engine feature")

    def _split_gen(self) -> torch.Generator:
        """A fresh generator seeded from the session's (its split)."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))
        return torch.Generator().manual_seed(seed)

    def _local_spec(self):
        return self.spec.replace(region_affinity=None,
                                 region_anti_affinity=None,
                                 region_power_budget_w=None,
                                 inter_region_hops=None)

    def _engine(self, g: int) -> dynamic.OnlineEmbedder:
        if g not in self._engines:
            self._engines[g] = dynamic.OnlineEmbedder(
                self.partition.regions[g].topo, spec=self._local_spec(),
                generator=self._split_gen(), device=self.device,
                monitor=self._region_monitors.get(g, self.monitor))
            self._engines[g].tick(self._now)
        return self._engines[g]

    def attach_region_monitors(self, make=None) -> Dict[int, object]:
        """Give every region engine its OWN ``PlacementMonitor`` (the
        session-level monitor keeps receiving coordinator events);
        ``fleet_monitor()`` rolls them all up.  ``make`` overrides the
        monitor factory."""
        from ..fault.monitor import PlacementMonitor
        make = make or PlacementMonitor
        for g in range(self.G):
            self._region_monitors[g] = make()
        for g, eng in self._engines.items():
            eng.monitor = self._region_monitors[g]
        if self._flat is not None:
            self._flat.engine.monitor = self._region_monitors[0]
        return dict(self._region_monitors)

    def fleet_monitor(self):
        """One merged fleet snapshot: the session monitor plus every
        per-region monitor (``PlacementMonitor.merge``)."""
        from ..fault.monitor import PlacementMonitor
        fleet = PlacementMonitor()
        if self.monitor is not None:
            fleet.merge(self.monitor)
        for g in sorted(self._region_monitors):
            fleet.merge(self._region_monitors[g])
        return fleet

    def _budget(self, g: int) -> Optional[float]:
        if g in self._budget_override:
            return self._budget_override[g]
        b = self.spec.region_power_budget_w
        if b is None:
            return None
        b = np.asarray(b, np.float64)  # tracelint: allow[CFN102]
        return float(b) if b.ndim == 0 else float(b[g])

    def _row_constraint(self, kind: str, row: int) -> int:
        v = getattr(self.spec, kind)
        if v is None:
            return -1
        v = np.asarray(v)
        if v.ndim == 0:
            return int(v)
        return int(v[row]) if row < v.shape[0] else -1

    def _allowed_regions(self, home: int, anti: int) -> List[int]:
        """Host-region candidates for a service homed at ``home``: the home
        region first, then the others by core distance, minus the
        forbidden region, the down ones and anything past the
        ``inter_region_hops`` cap."""
        cap = self.spec.inter_region_hops
        out = []
        order = sorted(range(self.partition.G),
                       key=lambda g: (g != home,
                                      int(self.partition.core_hops[home, g])))
        for g in order:
            if g == anti or g in self._down:
                continue
            if (g != home and cap is not None
                    and int(self.partition.core_hops[home, g]) > cap):
                continue
            out.append(g)
        return out

    # -- introspection ----------------------------------------------------
    @property
    def G(self) -> int:
        return self.partition.G

    @property
    def n_live(self) -> int:
        return self._flat.n_live if self._flat else len(self._order)

    @property
    def sids(self) -> List[int]:
        return self._flat.sids if self._flat else list(self._order)

    @property
    def result(self):
        return self._flat.result if self._flat else self._last_result

    @property
    def queued_sids(self) -> List[int]:
        """Every parked service id: the region engines' queues, then the
        federation's own fault queue."""
        if self._flat:
            return self._flat.engine.queued_sids
        out = [s for eng in self._engines.values() for s in eng.queued_sids]
        return out + [e[1] for e in self._fqueue]

    def service_vms(self, row: int) -> int:
        if self._flat:
            return self._flat.service_vms(row)
        return self._plans[self._order[row]].vsr.V

    def assignment(self, sid: int) -> int:
        """The region currently hosting service ``sid``'s free VMs."""
        if self._flat:
            return 0
        return self._plans[sid].assigned

    @property
    def X(self) -> Optional[np.ndarray]:
        """The merged-substrate placement [n_live, V_max] (merged proc
        indices, service order; a migrated service's input VM shows its
        true source node)."""
        if self._flat:
            return self._flat.X
        if not self._order:
            return None
        V = max(self._plans[s].vsr.V for s in self._order)
        X = np.zeros((len(self._order), V), np.int32)
        for r, sid in enumerate(self._order):
            X[r, :self._plans[sid].vsr.V] = self._service_nodes(sid)
        return X

    def _service_nodes(self, sid: int) -> np.ndarray:
        """Merged node per VM of one service (from its host engine)."""
        plan = self._plans[sid]
        eng = self._engines[plan.assigned]
        row = eng.sids.index(sid)
        reg = self.partition.regions[plan.assigned]
        V = plan.vsr.V
        nodes = reg.proc_ids[np.asarray(eng.X[row, :V])]
        if plan.migrated:
            nodes = nodes.copy()
            nodes[int(plan.vsr.input_vm[0])] = int(plan.vsr.src[0])
        return nodes

    def _cuts_merged(self) -> List[Tuple[float, int, int, bool]]:
        out = []
        for sid in self._order:
            plan = self._plans[sid]
            if not plan.migrated:
                continue
            nodes = self._service_nodes(sid)
            src_m = int(plan.vsr.src[0])
            for h, vm_col, src_is_input in plan.cuts:
                out.append((h, src_m, int(nodes[vm_col]), src_is_input))
        return out

    def breakdown(self) -> FederatedBreakdown:
        """Exact (float64) fleet accounting: per-region + inter-region
        watts; see ``federated_breakdown``."""
        if self._flat:
            eng = self._flat.engine
            if eng.problem is None:
                raise ValueError("empty session")
            states = [(0, eng.problem, np.asarray(eng.X))]
            return federated_breakdown(self.partition, states)
        states = [(g, e.problem, np.asarray(e.X))
                  for g, e in self._engines.items() if e.problem is not None]
        if not states:
            raise ValueError("empty session")
        return federated_breakdown(self.partition, states,
                                   cuts=self._cuts_merged())

    def power_w(self) -> float:
        return self.breakdown().total_w

    def region_watts(self) -> np.ndarray:
        return self.breakdown().regional_w

    def attribute(self) -> Dict[int, float]:
        """Per-tenant watts summing to the exact fleet total: each
        service's body (+ stub) attribution from its regional engines, plus
        the RESIDUAL -- what no engine sees (cut-link watts on home
        egress / shared core / host ingress, float32-vs-float64 rounding)
        -- split over the cross-region services by cut-traffic share (over
        everyone when there are none)."""
        if self._flat:
            return self._flat.attribute()
        out: Dict[int, float] = {s: 0.0 for s in self._order}
        for eng in self._engines.values():
            for sid, w in eng.per_service_power_w().items():
                out[sid] += w
        residual = self.breakdown().total_w - sum(out.values())
        cut_h = {sid: sum(h for h, _, _ in self._plans[sid].cuts)
                 for sid in self._order if self._plans[sid].migrated}
        tot_h = sum(cut_h.values())
        if tot_h > 0:
            for sid, h in cut_h.items():
                out[sid] += residual * h / tot_h
        elif self._order:
            for sid in self._order:
                out[sid] += residual / len(self._order)
        return out

    # -- batch path -------------------------------------------------------
    @_traced("federated_solve", ledger=True)
    def solve(self, vsrs: Optional[vsr_mod.VSRBatch] = None):
        """Embed a whole VSR batch across the federation (empty session),
        or re-pack the live regions (no batch: per-region defrag).

        Multi-region: one batched portfolio over all regions, a
        coordinator budget pass (cross-region migration on regional budget
        breaches, each followed by a re-solve), engines seeded from the
        result.  Returns a ``FederatedResult``.  Single-region: the flat
        ``CFNSession``'s solve."""
        if self._flat:
            return self._flat.solve(vsrs)
        if vsrs is None:
            return self.defrag()
        if self._order:
            raise ValueError("session already has live services; use "
                             "add()/remove() for churn or solve() with no "
                             "batch to re-pack")
        services = [vsr_mod.VSRBatch(F=vsrs.F[i:i + 1], H=vsrs.H[i:i + 1],
                                     src=vsrs.src[i:i + 1],
                                     input_vm=vsrs.input_vm[i:i + 1])
                    for i in range(vsrs.R)]
        sids = list(range(vsrs.R))
        self._next_sid = vsrs.R
        assigned = self._assign(services)
        migrations = 0
        while True:   # every applied migration is followed by a re-solve
            plans, problems, eligibles, X0s, region_rows = self._decompose(
                services, sids, assigned)
            X, obj = solve_portfolio_batched(
                problems, X0s, eligibles, spec=self.spec,
                gen=self._split_gen())
            bd = self._batch_breakdown(plans, problems, X)
            if migrations >= self.MAX_COORD_PASSES:
                break
            move = self._pick_migration(plans, bd, assigned)
            if move is None:
                break
            row, target = move
            if self.monitor is not None:
                self.monitor.count("region_budget_breach",
                                   detail=f"region={assigned[row]}")
                self.monitor.count(
                    "cross_region_migration",
                    detail=f"sid={sids[row]} -> region {target}")
            assigned[row] = target
            migrations += 1
        # commit: seed the per-region engines with the solved placements
        for g, rows in region_rows.items():
            if not rows:
                continue
            eng = self._engine(g)
            svc, ss, x0 = [], [], []
            for plan, kind in rows:
                r = plan.body_row if kind == "body" else plan.stub_row
                svc.append(plan.body if kind == "body" else plan.stub)
                ss.append(plan.sid)
                x0.append(X[g][r])
            eng.bootstrap(svc, sids=ss, X0=np.stack(x0))
        self._plans = {p.sid: p for p in plans}
        self._order = list(sids)
        res = FederatedResult(
            X=self._merged_X_from(plans, X),
            breakdown=self.breakdown(),
            assignments=np.asarray(assigned), region_obj=np.asarray(obj),
            migrations=migrations)
        self._last_result = res
        return res

    def _assign(self, services) -> List[int]:
        out = []
        for i, s in enumerate(services):
            home = self.partition.home_region(int(s.src[0]))
            aff = self._row_constraint("region_affinity", i)
            anti = self._row_constraint("region_anti_affinity", i)
            g = aff if aff >= 0 else home
            if g == anti:
                allowed = [a for a in self._allowed_regions(home, anti)
                           if a != g]
                if not allowed:
                    raise ValueError(f"service {i}: no admissible region "
                                     "(anti-affinity + hop cap exclude all)")
                g = allowed[0]
            if g != home:
                cap = self.spec.inter_region_hops
                if (cap is not None
                        and int(self.partition.core_hops[home, g]) > cap):
                    raise ValueError(
                        f"service {i}: affinity region {g} is "
                        f"{int(self.partition.core_hops[home, g])} core "
                        f"hops from home {home}, past inter_region_hops="
                        f"{cap}")
            out.append(g)
        return out

    def _decompose(self, services, sids, assigned):
        """Per-region plans, padded problems (on the session's device, host
        arrays on the padded route table), masks and warm starts."""
        part = self.partition
        subs, real_masks, _ = part.padded_substrates(self.device)
        host_rt = [d["route_idx"] for d in part.padded_arrays()[0]]
        plans = [make_plan(part, s, sid, g)
                 for s, sid, g in zip(services, sids, assigned)]
        region_rows: Dict[int, list] = {g: [] for g in range(part.G)}
        for plan in plans:
            plan.body_row = len(region_rows[plan.assigned])
            region_rows[plan.assigned].append((plan, "body"))
        for plan in plans:
            if plan.migrated:
                plan.stub_row = len(region_rows[plan.home])
                region_rows[plan.home].append((plan, "stub"))
        batches = []
        for g in range(part.G):
            rows = region_rows[g]
            if rows:
                b = vsr_mod.concat_all([p.body if kind == "body" else p.stub
                                        for p, kind in rows])
            else:
                b = _placeholder_service()
            if b.V < 2:
                # all-V=1 region: every VM is pinned, leaving the batched
                # solver no free position; the placeholder widens it with
                # free zero-demand columns (exactly a concat pad)
                b = b.concat(_placeholder_service())
            batches.append(b)
        R_max = max(b.R for b in batches)
        R_pad = (dynamic._bucket_rows(R_max, lo=self.spec.row_bucket_lo)
                 if self.spec.bucket_rows else R_max)
        V_max = max(b.V for b in batches)
        V_pad = (dynamic._bucket_rows(V_max, lo=self.spec.col_bucket_lo)
                 if self.spec.bucket_cols else V_max)
        problems, eligibles, X0s = [], [], []
        for g, b in enumerate(batches):
            reg = part.regions[g]
            prob = power.build_problem(reg.topo, b, substrate=subs[g],
                                       pad_to_rows=R_pad, pad_to_cols=V_pad)
            prob.__dict__["host"] = prob.host._replace(route_idx=host_rt[g])
            # spec.masks anchors a migrated body's hop radius at its host
            # pin (the region CDC, see Region.pin_node) -- the semantics the
            # seeded region engines enforce on churn and defrag
            el = self.spec.masks(prob)
            el = (np.ones((prob.R, prob.P), bool) if el is None
                  else np.asarray(el, bool))
            el &= real_masks[g][None, :]
            problems.append(prob)
            eligibles.append(el)
            cdc = reg.topo.layer_indices("cdc")
            start = cdc[0] if cdc else 0
            X0s.append(np.full((prob.R, prob.V), start, np.int32))
        return plans, problems, eligibles, X0s, region_rows

    def _batch_breakdown(self, plans, problems, X) -> FederatedBreakdown:
        states = [(g, problems[g], X[g]) for g in range(self.partition.G)]
        cuts = []
        for plan in plans:
            if not plan.migrated:
                continue
            reg = self.partition.regions[plan.assigned]
            src_m = int(plan.vsr.src[0])
            for h, vm_col, src_is_input in plan.cuts:
                dst_local = int(X[plan.assigned][plan.body_row, vm_col])
                cuts.append((h, src_m, int(reg.proc_ids[dst_local]),
                             src_is_input))
        return federated_breakdown(self.partition, states, cuts=cuts)

    def _pick_migration(self, plans, bd: FederatedBreakdown,
                        assigned) -> Optional[Tuple[int, int]]:
        """Coordinator: the (service row, target region) move for the worst
        budget breach, or None when every region is within budget (or no
        admissible move exists)."""
        over = [(bd.regional_w[g] - b, g) for g in range(self.partition.G)
                if (b := self._budget(g)) is not None
                and bd.regional_w[g] > b]
        if not over:
            return None
        _, g = max(over)
        movable = [i for i, p in enumerate(plans)
                   if assigned[i] == g
                   and self._row_constraint("region_affinity", i) < 0]
        if not movable:
            return None
        # move the heaviest service to the coolest admissible region
        row = max(movable, key=lambda i: float(np.sum(plans[i].vsr.F)))
        anti = self._row_constraint("region_anti_affinity", row)
        home = plans[row].home
        cands = [c for c in self._allowed_regions(home, anti)
                 if c != g and (self._budget(c) is None
                                or bd.regional_w[c] < self._budget(c))]
        if not cands:
            return None
        target = min(cands, key=lambda c: bd.regional_w[c])
        return row, target

    def _merged_X_from(self, plans, X) -> np.ndarray:
        V = max(p.vsr.V for p in plans)
        out = np.zeros((len(plans), V), np.int32)
        for r, plan in enumerate(plans):
            reg = self.partition.regions[plan.assigned]
            nodes = reg.proc_ids[X[plan.assigned][plan.body_row,
                                                  :plan.vsr.V]]
            if plan.migrated:
                nodes = nodes.copy()
                nodes[int(plan.vsr.input_vm[0])] = int(plan.vsr.src[0])
            out[r, :plan.vsr.V] = nodes
        return out

    # -- region-aware churn ------------------------------------------------
    def _check_scalar_constraints(self, call: str, hint: str) -> None:
        for kind in ("region_affinity", "region_anti_affinity"):
            v = getattr(self.spec, kind)
            if v is not None and np.ndim(v) > 0:
                raise ValueError(f"{call} with a sequence {kind} is "
                                 f"unsupported{hint}")

    @_traced("federated_add", ledger=True)
    def add(self, service: vsr_mod.VSRBatch, sid: Optional[int] = None,
            region: Optional[int] = None, priority: Optional[int] = None):
        """Admit one service: an incremental churn event on its region's
        engine.  On a regional budget breach the arrival is migrated to
        the coolest admissible region (stub left at home, cut links priced
        over the core); ``None`` = rejected everywhere (or parked, when its
        home region is down).  ``priority`` is the admission class,
        threaded to the region engine's priority queue."""
        if self._flat:
            return self._flat.add(service, sid=sid, priority=priority)
        if service.R != 1:
            raise ValueError(f"add() takes one service, got R={service.R}")
        self._check_scalar_constraints(
            "add()", ": it binds to batch rows, and churn would silently "
            "re-assign constraints across services.  Use a scalar, or pass "
            "region= explicitly.")
        if sid is None:
            sid = self._next_sid
        if sid in self._plans:
            raise ValueError(f"sid {sid} is already live")
        self._next_sid = max(self._next_sid, sid + 1)
        home = self.partition.home_region(int(service.src[0]))
        prio = 0 if priority is None else int(priority)
        if home in self._down:
            # the source region is dark: its pinned input VM cannot run, so
            # the arrival is parked (never dropped) and retried on recovery
            self._fqueue.append((service, sid, prio))
            if self.monitor is not None:
                self.monitor.strand(sid, self._now,
                                    detail=f"sid={sid} home {home} down")
            return None
        aff = self._row_constraint("region_affinity", 0)
        anti = self._row_constraint("region_anti_affinity", 0)
        if region is not None:
            targets = [region]
        elif aff >= 0:
            targets = [aff]
        else:
            targets = self._allowed_regions(home, anti)
        targets = [g for g in targets if g not in self._down]
        if not targets:
            return None
        cap = self.spec.inter_region_hops
        for g in targets:
            # pinned targets (region= / affinity) get the hop-cap check the
            # batch path's _assign makes
            if (g != home and cap is not None
                    and int(self.partition.core_hops[home, g]) > cap):
                raise ValueError(
                    f"region {g} is {int(self.partition.core_hops[home, g])}"
                    f" core hops from home {home}, past inter_region_hops="
                    f"{cap}")
        migrated_off: Optional[int] = None
        for k, g in enumerate(targets):
            res = self._try_add(service, sid, g, prio)
            if res is None:
                continue
            budget = self._budget(g)
            home_budget = self._budget(home)
            if budget is not None or (g != home and home_budget is not None):
                bd = self.breakdown()
                if budget is not None and bd.regional_w[g] > budget:
                    if self.monitor is not None:
                        self.monitor.count("region_budget_breach",
                                           detail=f"region={g} sid={sid}")
                    if k + 1 < len(targets):
                        self._drop(sid)
                        if migrated_off is None:
                            migrated_off = g
                        continue
                    # no cooler region admits it: kept best-effort (the
                    # breach is counted for the operator)
                if (g != home and home_budget is not None
                        and bd.regional_w[home] > home_budget
                        and self.monitor is not None):
                    # the stub (pinned input compute + cut egress) can push
                    # the HOME region over budget; it is physically pinned
                    # there, so this is surfaced rather than migrated
                    self.monitor.count(
                        "region_budget_breach",
                        detail=f"region={home} sid={sid} (stub)")
            if migrated_off is not None and self.monitor is not None:
                # ONE migration per arrival that finally landed, counted at
                # the region where it stays
                self.monitor.count(
                    "cross_region_migration",
                    detail=f"sid={sid} region {migrated_off} -> {g}")
            if self.monitor is not None:
                # closes the availability window of a service stranded by a
                # region fault (no-op otherwise)
                self.monitor.unstrand(sid, self._now)
            return res
        return None

    def _try_add(self, service, sid, g, prio: int = 0):
        plan = make_plan(self.partition, service, sid, g)
        eng = self._engine(g)
        res = eng.add(plan.body, sid=sid, priority=prio)
        if res is None:
            return None
        if plan.migrated:
            stub_res = self._engine(plan.home).add(plan.stub, sid=sid,
                                                   priority=prio)
            if stub_res is None:   # stub refused (pathological budgets)
                eng.remove(sid)
                return None
        self._plans[sid] = plan
        self._order.append(sid)
        self._prio[sid] = prio
        return res

    def _forget(self, sid: int) -> None:
        self._plans.pop(sid)
        self._order.remove(sid)
        self._prio.pop(sid, None)

    def _drop(self, sid: int) -> None:
        plan = self._plans[sid]
        self._engines[plan.assigned].remove(sid)
        if plan.migrated:
            self._engines[plan.home].remove(sid)
        self._forget(sid)

    @_traced("federated_remove", ledger=True)
    def remove(self, sid: int):
        """Retire a service from its region engine(s) (body + stub)."""
        if self._flat:
            return self._flat.remove(sid)
        if sid not in self._plans:
            raise KeyError(f"no live service {sid}")
        plan = self._plans[sid]
        res = self._engines[plan.assigned].remove(sid)
        if plan.migrated:
            self._engines[plan.home].remove(sid)
        self._forget(sid)
        return res

    @_traced("federated_wave", ledger=True)
    def apply_wave(self, arrivals: Sequence = (),
                   departures: Sequence[int] = ()):
        """Apply one churn wave across the federation.

        Arrivals homed in an up region with no budget pressure batch into
        ONE ``OnlineEmbedder.apply_wave`` per target region; anything that
        needs the coordinator -- budget-breach migration, affinity
        steering off-home, a down home region -- falls back to the
        per-event ``add``, as does any arrival its home-region wave
        refused.  Non-migrated departures batch per host region; migrated
        ones (body + stub in two regions) retire per event.  Returns an
        aggregated ``dynamic.WaveResult`` whose ``result`` is None (there
        is no single fleet ``SolveResult``; use ``breakdown()``)."""
        if self._flat:
            return self._flat.apply_wave(arrivals, departures)
        self._check_scalar_constraints("apply_wave()", " (see add())")
        arr: List[tuple] = []
        seen: set = set()
        for a in arrivals:
            if isinstance(a, (tuple, list)):
                svc = a[0]
                sid = a[1] if len(a) > 1 else None
                prio = int(a[2]) if len(a) > 2 and a[2] is not None else 0
            else:
                svc, sid, prio = a, None, 0
            if svc.R != 1:
                raise ValueError(
                    f"wave arrivals must be R=1, got R={svc.R}")
            if sid is None:
                sid = self._next_sid
            if sid in self._plans or sid in seen:
                raise ValueError(f"sid {sid} is already live")
            seen.add(sid)
            self._next_sid = max(self._next_sid, sid + 1)
            arr.append((svc, int(sid), prio))
        deps = [int(s) for s in departures]
        if len(deps) != len(set(deps)):
            raise ValueError("duplicate departure sid in wave")
        for s in deps:
            if s not in self._plans:
                raise KeyError(f"no live service {s}")
        wr = dynamic.WaveResult(result=None,
                                sids=[sid for _, sid, _ in arr],
                                departed=deps)
        if not arr and not deps:
            return wr
        aff = self._row_constraint("region_affinity", 0)
        anti = self._row_constraint("region_anti_affinity", 0)
        budgets = (self.spec.region_power_budget_w is not None
                   or bool(self._budget_override))
        dep_by_g: Dict[int, List[int]] = {}
        for s in deps:
            plan = self._plans[s]
            if plan.migrated:
                self.remove(s)
            else:
                dep_by_g.setdefault(plan.assigned, []).append(s)
        arr_by_g: Dict[int, List[tuple]] = {}
        slow_arr: List[tuple] = []
        for svc, sid, prio in arr:
            home = self.partition.home_region(int(svc.src[0]))
            g = aff if aff >= 0 else home
            if budgets or g != home or home in self._down or anti == g:
                slow_arr.append((svc, sid, prio))
            else:
                arr_by_g.setdefault(g, []).append((svc, sid, prio))
        svc_of = {sid: (svc, prio) for svc, sid, prio in arr}
        for g in sorted(set(dep_by_g) | set(arr_by_g)):
            a_g = arr_by_g.get(g, [])
            plans = {sid: make_plan(self.partition, svc, sid, g)
                     for svc, sid, _ in a_g}
            prios = {sid: prio for _, sid, prio in a_g}
            wres = self._engine(g).apply_wave(
                [(plans[sid].body, sid, prios[sid]) for _, sid, _ in a_g],
                dep_by_g.get(g, ()))
            for s in wres.departed:
                self._forget(s)
            for sid in wres.admitted:
                self._plans[sid] = plans[sid]
                self._order.append(sid)
                self._prio[sid] = prios[sid]
            wr.admitted.extend(wres.admitted)
            wr.queued.extend(wres.queued)
            wr.n_preempted += wres.n_preempted
            for sid in wres.rejected:
                svc, prio = svc_of[sid]
                slow_arr.append((svc, sid, prio))
        # coordinator fallbacks admit in priority order (class first, wave
        # input order within a class)
        pos = {sid: i for i, sid in enumerate(wr.sids)}
        slow_arr.sort(key=lambda e: (e[2], pos[e[1]]))
        for svc, sid, prio in slow_arr:
            res = self.add(svc, sid=sid, priority=prio)
            if res is not None:
                wr.admitted.append(sid)
            elif (any(e[1] == sid for e in self._fqueue)
                  or any(sid in eng.queued_sids
                         for eng in self._engines.values())):
                wr.queued.append(sid)
            else:
                wr.rejected.append(sid)
        return wr

    def defrag(self):
        """Per-region full-portfolio re-pack (each under the spec masks)."""
        if self._flat:
            return self._flat.defrag()
        return {g: eng.defrag() for g, eng in self._engines.items()
                if eng.problem is not None}

    def defrag_tick(self, rows: Optional[int] = None):
        """One amortized background-defrag slice on every live region
        engine (``OnlineEmbedder.defrag_tick``).  Returns ``{region:
        SolveResult}`` for regions whose slice improved the objective."""
        if self._flat:
            return self._flat.defrag_tick(rows)
        out = {}
        for g, eng in self._engines.items():
            if eng.problem is not None:
                res = eng.defrag_tick(rows)
                if res is not None:
                    out[g] = res
        return out

    # -- fault plane -------------------------------------------------------
    def tick(self, t: float) -> None:
        """Advance the federation clock (hours), propagated to every region
        engine -- availability windows are timestamped from it."""
        self._now = float(t)
        if self._flat is not None:
            self._flat.tick(t)
        for eng in self._engines.values():
            eng.tick(t)

    @property
    def down_regions(self) -> List[int]:
        return sorted(self._down)

    def _readmit(self, sid: int, detail: str) -> bool:
        """Retire a live service and admit it again through ``add`` (the
        regions it may land in are ``_allowed_regions``'); park it when no
        region admits it.  True when it landed."""
        svc, prio = self._plans[sid].vsr, self._prio.get(sid, 0)
        self.remove(sid)
        if self.add(svc, sid=sid, priority=prio) is not None:
            return True
        self._park(svc, sid, detail, prio=prio)
        return False

    def fail_region(self, g: int) -> int:
        """Fail a whole region: services HOMED there are stranded (their
        pinned sources died with the region; parked for recovery), services
        merely HOSTED there are evacuated to the coolest admissible region
        through the ordinary admission path.  Returns the evacuation
        count."""
        if self._flat is not None:
            raise ValueError("fail_region needs a multi-region federation; "
                             "use engine-level fail_node on a flat session")
        if g in self._down:
            return 0
        self._down.add(g)
        if self.monitor is not None:
            self.monitor.count("region_failed", detail=f"region={g}")
        # strand first: sources in g are gone wherever the body sits
        for sid in [s for s in self._order if self._plans[s].home == g]:
            svc = self._plans[sid].vsr
            prio = self._prio.get(sid, 0)
            self.remove(sid)
            self._fqueue.append((svc, sid, prio))
            if self.monitor is not None:
                self.monitor.strand(sid, self._now,
                                    detail=f"sid={sid} region {g} failed")
        # evacuate: bodies hosted in g whose homes survive re-admit through
        # add() -- the budget-breach migration path of any arrival, with g
        # excluded by _allowed_regions
        n_evac = 0
        for sid in [s for s in self._order
                    if self._plans[s].assigned == g]:
            if self._readmit(sid, f"sid={sid} evacuation refused"):
                n_evac += 1
                if self.monitor is not None:
                    self.monitor.count(
                        "evacuation",
                        detail=f"sid={sid} region {g} -> "
                               f"{self.assignment(sid)}")
        return n_evac

    def recover_region(self, g: int) -> int:
        """Recover a region and retry every parked service (stranded by
        failures, brownout sheds, or arrivals during the outage).  Returns
        the number re-admitted."""
        if self._flat is not None:
            raise ValueError("recover_region needs a multi-region "
                             "federation")
        if g not in self._down:
            return 0
        self._down.discard(g)
        if self.monitor is not None:
            self.monitor.count("region_recovered", detail=f"region={g}")
        return self._drain_fqueue()

    def brownout_region(self, g: int, budget_w: float) -> int:
        """Tighten region ``g``'s power budget mid-run and shed load until
        the region is within it: the heaviest movable services re-admit
        through the ordinary budget-breach migration path (each shed
        counts a ``region_budget_breach`` + ``cross_region_migration``).
        Returns the number of services moved or parked."""
        if self._flat is not None:
            self._flat.brownout(budget_w)
            return 0
        self._budget_override[g] = float(budget_w)
        if self.monitor is not None:
            self.monitor.count("brownout",
                               detail=f"region={g} budget_w={budget_w}")
        moved = 0
        prev_w = None
        for _ in range(len(self._order)):
            try:
                bd = self.breakdown()
            except ValueError:   # empty session
                break
            w = float(bd.regional_w[g])
            if w <= budget_w:
                break
            if prev_w is not None and w >= prev_w - 1e-9:
                # the last shed did not cool the region (stub compute and
                # cut-link idle watts stay pinned home): stop best-effort
                break
            prev_w = w
            movable = [s for s in self._order
                       if self._plans[s].assigned == g
                       and self._row_constraint("region_affinity", 0) < 0]
            if not movable:
                break
            victim = max(movable,
                         key=lambda s: float(np.sum(self._plans[s].vsr.F)))
            before = self.assignment(victim)
            if not self._readmit(victim, f"sid={victim} brownout shed"):
                moved += 1
                continue
            if self.assignment(victim) == before:
                break   # nowhere cooler admits it: best-effort stay
            moved += 1
        return moved

    def brownout_end_region(self, g: int) -> None:
        """Restore region ``g``'s configured budget and retry parked
        services."""
        if self._flat is not None:
            self._flat.brownout_end()
            return
        if self._budget_override.pop(g, None) is None:
            return
        if self.monitor is not None:
            self.monitor.count("brownout_end", detail=f"region={g}")
        self._drain_fqueue()

    def _park(self, service, sid: int, detail: str, prio: int = 0) -> None:
        if all(e[1] != sid for e in self._fqueue):
            self._fqueue.append((service, sid, prio))
        if self.monitor is not None:
            self.monitor.strand(sid, self._now, detail=detail)

    def _drain_fqueue(self) -> int:
        """Retry every parked service in priority order (class first,
        arrival order within a class); still-unplaceable ones re-park
        (never silently dropped)."""
        queued, self._fqueue = self._fqueue, []
        queued = sorted(enumerate(queued), key=lambda e: (e[1][2], e[0]))
        admitted = 0
        for _, (svc, sid, prio) in queued:
            # re-parks itself if home is down
            res = self.add(svc, sid=sid, priority=prio)
            if res is not None:
                admitted += 1
            elif all(e[1] != sid for e in self._fqueue):
                self._fqueue.append((svc, sid, prio))
        return admitted

    def cancel_queued(self, sid: int) -> bool:
        """Drop a parked service (its lifetime ended while stranded)."""
        n0 = len(self._fqueue)
        self._fqueue = [e for e in self._fqueue if e[1] != sid]
        removed = len(self._fqueue) < n0
        if removed and self.monitor is not None:
            self.monitor.unstrand(sid, self._now, re_embedded=False)
        return removed

    @_traced("federated_fault", ledger=True)
    def apply_fault(self, ev: dynamic.FaultEvent):
        """Dispatch one ``FaultEvent`` at region granularity (node / link
        kinds belong to flat engines; the federated substrate faults whole
        regions)."""
        if ev.kind == "fail_region":
            return self.fail_region(int(ev.target))
        if ev.kind == "recover_region":
            return self.recover_region(int(ev.target))
        if ev.kind == "brownout":
            return self.brownout_region(int(ev.target), float(ev.value))
        if ev.kind == "brownout_end":
            return self.brownout_end_region(int(ev.target))
        raise ValueError(
            f"FederatedSession cannot apply fault kind {ev.kind!r}: "
            "substrate faults are region-granular here (fail_region / "
            "recover_region / brownout)")

    def replay(self, events: Sequence[dynamic.ServiceEvent], make_vsr,
               on_event=None, waves: bool = False) -> list:
        """Drive the federation through a churn timeline (region-aware
        ``dynamic.replay`` semantics: unknown departures cancel a parked
        service or are skipped).  ``FaultEvent``s interleave via
        ``apply_fault``, the clock ticked to each event's time.
        ``waves=True`` groups same-tick service events into one
        ``apply_wave`` each (fault events stay single-event barriers) and
        runs a background ``defrag_tick`` after every wave when
        ``spec.defrag_rows_per_tick`` is set.  Returns ``(event, result)``
        pairs."""
        if self._flat:
            return self._flat.replay(events, make_vsr, on_event,
                                     waves=waves)
        if waves:
            return self._replay_waves(events, make_vsr, on_event)
        live = set(self._order)
        stats = []
        for ev in events:
            self.tick(ev.t)
            if isinstance(ev, dynamic.FaultEvent):
                res = self.apply_fault(ev)
                live = set(self._order)
                stats.append((ev, res))
                if on_event is not None:
                    on_event(ev, res)
                continue
            if ev.kind == "arrive":
                res = self.add(make_vsr(ev.sid), sid=ev.sid)
                if res is not None:
                    live.add(ev.sid)
            else:
                if ev.sid not in live:
                    self.cancel_queued(ev.sid)
                    continue
                res = self.remove(ev.sid)
                live.discard(ev.sid)
                live.update(self._order)   # recovery / queue re-admissions
            stats.append((ev, res))
            if on_event is not None:
                on_event(ev, res)
        return stats

    def _replay_waves(self, events, make_vsr, on_event) -> list:
        """The federated ``replay(..., waves=True)`` loop: collect ->
        apply_wave (per-region batched) -> background defrag tick."""
        defrag_budget = self.spec.defrag_rows_per_tick
        stats = []
        for group in dynamic.iter_waves(events):
            self.tick(group[-1].t)
            if isinstance(group[0], dynamic.FaultEvent):
                res = self.apply_fault(group[0])
                stats.append((group[0], res))
                if on_event is not None:
                    on_event(group[0], res)
                continue
            live = set(self._order)
            arrivals, departures = [], []
            for ev in group:
                if ev.kind == "arrive":
                    arrivals.append((make_vsr(ev.sid), ev.sid))
                elif ev.sid in live:
                    departures.append(ev.sid)
                else:
                    self.cancel_queued(ev.sid)
            wres = self.apply_wave(arrivals, departures)
            if defrag_budget:
                self.defrag_tick()
            for ev in group:
                stats.append((ev, wres))
                if on_event is not None:
                    on_event(ev, wres)
        return stats
