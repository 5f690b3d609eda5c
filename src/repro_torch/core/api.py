"""Unified placement API: one declarative constraint object, one session.

  * **PlacementSpec** -- a frozen, declarative bundle of everything that
    constrains or configures a solve: per-service ``max_hops`` /
    eligibility masks, admission budgets, R- and V-shape bucketing policy,
    portfolio method/effort, and the anneal backend.  ``spec.masks(problem)``
    builds the [R, P] eligibility mask in ONE place; every solver path
    consumes that same mask.
  * **CFNSession** -- topology + spec + the live result, on one device:
    ``solve(vsrs)`` embeds a whole VSR batch, ``savings_vs_baseline``
    reports the paper's headline metric.

    from repro_torch.api import CFNSession, PlacementSpec
    spec = PlacementSpec(max_hops=2)
    session = CFNSession(topo, spec)         # on the CUDA card by default
    session.solve(vsrs)

Not yet ported (ROADMAP Queue 1): the online churn methods (``add``,
``remove``, ``apply_wave``, ``defrag``, the fault handlers) and substrate
health, with the online-engine slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import embed as embed_mod, vsr as vsr_mod
from .embed import METHODS
from .power import (Device, PlacementProblem, build_problem, resolve_device,
                    substrate_arrays)
from .solvers import SolveResult, _pow2, default_generator, solve_portfolio
from .topology import CFNTopology

__all__ = ["PlacementSpec", "CFNSession", "SolveResult", "solve_portfolio"]

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
      * ``health`` -- substrate up/down state; not ported yet, so a spec
        that sets it raises.
    Federation fields (``region_*``, ``inter_region_hops``) and admission
    budgets (``power_budget_w``, ``violation_tol``, ``queue_rejected``,
    ``priority_classes``, ``preempt``, ``defrag_rows_per_tick``) are kept
    for the slices that consume them; the batch path ignores them.
    Shape bucketing: ``bucket_rows``/``bucket_cols`` pad R and V to
    power-of-two buckets (``row_bucket_lo``/``col_bucket_lo`` the smallest).
    Solver: ``method`` (one of ``embed.METHODS``), ``effort`` ("quick",
    "standard" = +4000-step anneal, "high" = +12000 steps and genetic),
    ``backend`` ("auto"/"delta"/"fused"/"full"), and the incremental
    re-solve knobs of the online slice.
    """

    # constraints --------------------------------------------------------
    max_hops: Optional[Union[int, Sequence[int], np.ndarray]] = None
    eligible: Optional[np.ndarray] = None
    health: Optional[object] = None
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
        if self.health is not None:
            raise NotImplementedError(
                "PlacementSpec(health=...) needs SubstrateHealth, which "
                "comes with the fault plane (ROADMAP Queue 1, item 5 (c))")

    def replace(self, **changes) -> "PlacementSpec":
        """A copy with ``changes`` applied (validation re-runs)."""
        return dataclasses.replace(self, **changes)

    # -- the one place constraint masks are built -------------------------
    def masks(self, problem: PlacementProblem) -> Optional[np.ndarray]:
        """The [R, P] node-eligibility mask this spec imposes on a problem,
        or ``None`` when unconstrained.  Hop counts come from the problem's
        own route table, each service's source from its pinned input VM."""
        if self.max_hops is None and self.eligible is None:
            return None
        R, P = problem.R, problem.P
        el = np.ones((R, P), dtype=bool)
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
    """The CFN placement facade: topology + spec + live result, one device.

    ``device=None`` means the CUDA card (and raises without one); random
    draws come from ``generator`` (a CPU ``torch.Generator``, seed 1 by
    default), advanced by every full solve.
    """

    def __init__(self, topo: CFNTopology,
                 spec: Optional[PlacementSpec] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        self.topo = topo
        self.spec = spec if spec is not None else PlacementSpec()
        self.device = resolve_device(device)
        self._gen = default_generator(1) if generator is None else generator
        self._substrate = None
        self._batch: Optional[vsr_mod.VSRBatch] = None
        self._n_live = 0
        self._problem: Optional[PlacementProblem] = None
        self._result: Optional[SolveResult] = None

    # -- introspection ----------------------------------------------------
    @property
    def n_live(self) -> int:
        return self._n_live

    @property
    def problem(self) -> Optional[PlacementProblem]:
        return self._problem

    @property
    def X(self) -> Optional[np.ndarray]:
        return None if self._result is None else self._result.X.copy()

    @property
    def result(self) -> Optional[SolveResult]:
        return self._result

    def power_w(self) -> float:
        return 0.0 if self._result is None else self._result.power

    def objective(self) -> float:
        return float("nan") if self._result is None \
            else self._result.objective

    def masks(self) -> Optional[np.ndarray]:
        """The live problem's eligibility mask under this spec."""
        return (None if self._problem is None
                else self.spec.masks(self._problem))

    # -- solving ----------------------------------------------------------
    def solve(self, vsrs: Optional[vsr_mod.VSRBatch] = None
              ) -> SolveResult:
        """Embed a whole VSR batch under the spec: the batch becomes the
        session's live services -- one full solve with ``spec.method`` /
        ``effort``, constraint masks applied, rows and VM columns padded to
        their power-of-two buckets when ``spec.bucket_rows`` /
        ``bucket_cols`` are set."""
        if vsrs is None:
            raise NotImplementedError(
                "re-packing the live set (solve() with no batch, defrag) "
                "comes with the online-engine slice (ROADMAP Queue 1, "
                "item 5)")
        if self._n_live:
            raise ValueError(
                "session already has live services; churn (add/remove) "
                "comes with the online-engine slice")
        services = _split_services(vsrs)
        if not services:
            raise ValueError("solve() needs at least one service")
        batch = vsr_mod.concat_all(services)
        spec = self.spec
        if self._substrate is None:
            self._substrate = substrate_arrays(self.topo, self.device)
        self._problem = build_problem(
            self.topo, batch, substrate=self._substrate,
            pad_to_rows=(_pow2(len(services), lo=spec.row_bucket_lo)
                         if spec.bucket_rows else None),
            pad_to_cols=(_pow2(batch.V, lo=spec.col_bucket_lo)
                         if spec.bucket_cols else None))
        self._batch, self._n_live = batch, len(services)
        self._result = embed_mod._embed(self.topo, batch, spec,
                                        gen=self._gen, problem=self._problem)
        return self._result

    # -- reporting --------------------------------------------------------
    def savings_vs_baseline(self, baseline: str = "cdc") -> dict:
        """Paper headline metric for the live set: power saving vs a
        fixed-layer baseline, BOTH solved under this spec's constraints
        (masks, effort, backend) on an unpadded problem."""
        if self._batch is None:
            raise ValueError("empty session")
        problem = build_problem(self.topo, self._batch,
                                substrate=self._substrate)
        base = embed_mod._embed(self.topo, self._batch,
                                self.spec.replace(method=baseline),
                                problem=problem)
        opt = embed_mod._embed(self.topo, self._batch, self.spec,
                               problem=problem)
        saving = 1.0 - opt.power / max(base.power, 1e-9)
        return dict(baseline_w=base.power, optimized_w=opt.power,
                    saving_frac=saving, baseline=base, optimized=opt)
