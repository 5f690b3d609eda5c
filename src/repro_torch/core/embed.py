"""High-level embedding API: the paper's technique as one call.

    topo = topology.paper_topology()
    vsrs = vsr.random_vsrs(10, rng=0, source_nodes=[0])
    spec = api.PlacementSpec(method="cfn-milp")
    result = api.CFNSession(topo, spec).solve(vsrs)

``_embed`` is the spec-driven dispatch every batch path goes through;
"cfn-milp" is the portfolio stand-in for the paper's CPLEX run, and
"cdc"/"af"/"mf" are the paper's Fig. 3 baselines.  ``embed_latency_bounded``
remains as a deprecated shim.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from . import solvers
from .power import Device, PlacementProblem, build_problem
from .topology import CFNTopology
from .vsr import VSRBatch

METHODS = ("cdc", "af", "mf", "iot", "coordinate", "exhaustive", "anneal",
           "genetic", "relax", "cfn-milp")


def _spec(**fields):
    """A PlacementSpec (deferred import: api imports this module)."""
    from . import api
    return api.PlacementSpec(**fields)


def _embed(topo: CFNTopology, vsrs: VSRBatch, spec,
           gen: Optional[torch.Generator] = None,
           problem: Optional[PlacementProblem] = None,
           device: Device = None) -> solvers.SolveResult:
    """Spec-driven embedding dispatch -- the single batch-path consumer.

    ``spec.masks(problem)`` is built ONCE here and threaded into whichever
    solver ``spec.method`` selects; solvers without native masking (the
    fixed-layer baselines) are forced onto the mask by
    ``solvers.repair_to_eligible`` afterwards.  Without ``problem`` one is
    built on ``device``.
    """
    problem = (build_problem(topo, vsrs, device=device) if problem is None
               else problem)
    gen = solvers.default_generator() if gen is None else gen
    eligible = spec.masks(problem)
    m = spec.method
    if m in ("cdc", "af", "mf", "iot"):
        res = solvers.fixed_layer(problem, topo, m)
    elif m == "coordinate":
        cdc = topo.layer_indices("cdc")[0]
        X0 = np.full((problem.R, problem.V), cdc, dtype=np.int32)
        res = solvers.coordinate(problem, X0, eligible=eligible)
    elif m == "exhaustive":
        res = solvers.exhaustive(problem, eligible=eligible)
    elif m == "anneal":
        X0 = solvers.fixed_layer(problem, topo, "iot").X
        res = solvers.anneal(problem, gen, X0, backend=spec.backend,
                             eligible=eligible)
    elif m == "genetic":
        X0 = solvers.fixed_layer(problem, topo, "iot").X
        res = solvers.genetic(problem, gen, X0, eligible=eligible)
    elif m == "relax":
        res = solvers.relax(problem, gen, eligible=eligible)
    elif m == "cfn-milp":
        res = solvers.solve_portfolio(problem, topo, spec, gen,
                                      eligible=eligible)
    else:
        raise ValueError(f"unknown method {m!r}; choose from {METHODS}")
    if eligible is not None:
        res = solvers.repair_to_eligible(problem, res, eligible)
    return res


def embed(topo: CFNTopology, vsrs: VSRBatch, spec=None,
          gen: Optional[torch.Generator] = None,
          problem: Optional[PlacementProblem] = None,
          device: Device = None) -> solvers.SolveResult:
    """The paper's technique as one call: embed ``vsrs`` on ``topo`` under
    ``spec`` (default ``PlacementSpec()``: cfn-milp, standard effort)."""
    spec = _spec() if spec is None else spec
    return _embed(topo, vsrs, spec, gen=gen, problem=problem, device=device)


def embed_latency_bounded(topo: CFNTopology, vsrs: VSRBatch,
                          max_hops: int, method: str = "cfn-milp",
                          gen: Optional[torch.Generator] = None,
                          device: Device = None) -> solvers.SolveResult:
    """Latency-constrained embedding (paper Sec. 2: "latency can easily be
    added"): every VM placed within ``max_hops`` network nodes of its
    VSR's source.

    Deprecated shim keeping the historical semantics: an unconstrained
    solve, then ``solvers.repair_to_eligible`` of each violating VM onto
    the hop mask of ``PlacementSpec.masks``.  New code sets
    ``PlacementSpec(max_hops=...)``, which threads the mask through every
    solver instead of repairing afterwards.
    """
    warnings.warn(
        "embed_latency_bounded() is deprecated; set "
        "repro_torch.api.PlacementSpec(max_hops=...) and use "
        "repro_torch.api.CFNSession", DeprecationWarning, stacklevel=2)
    spec = _spec(method=method, max_hops=max_hops)
    problem = build_problem(topo, vsrs, device=device)
    base = _embed(topo, vsrs, spec.replace(max_hops=None), gen=gen,
                  problem=problem)
    res = solvers.repair_to_eligible(problem, base, spec.masks(problem))
    return solvers._result(problem, res.X,
                           f"latency<={max_hops}({base.method})")


def savings_vs_baseline(topo: CFNTopology, vsrs: VSRBatch,
                        baseline: str = "cdc", method: str = "cfn-milp",
                        device: Device = None) -> dict:
    """Paper headline metric: power saving of CFN placement vs the
    baseline.  Baseline and optimized runs share the same seed."""
    problem = build_problem(topo, vsrs, device=device)
    base = _embed(topo, vsrs, _spec(method=baseline), problem=problem)
    opt = _embed(topo, vsrs, _spec(method=method), problem=problem)
    saving = 1.0 - opt.power / max(base.power, 1e-9)
    return dict(baseline_w=base.power, optimized_w=opt.power,
                saving_frac=saving, baseline=base, optimized=opt)
