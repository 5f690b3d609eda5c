"""The paper's tables on the port (the JAX package's drivers are
``benchmarks/paper_figures.py``).

  fig3        -- total power of CDC / AF / MF / CFN-MILP at 1..20 VSRs, and
                 the headline savings statistics (paper: mean 68 %, minimum
                 19 %, maximum 91 %).
  fig4        -- network vs processing power of each policy.
  solver_gap  -- each solver's optimality gap against exhaustive
                 enumeration on small instances.

Each returns its rows (a list of dicts, rounded as the JAX package's
drivers round them; seconds unrounded) and writes a CSV only when given a
directory.  Every solve runs on ``device`` (``None``: the CUDA card); the
seed ``n`` of the JAX package's ``jax.random.PRNGKey(n)`` becomes a
``torch.Generator`` seeded with ``n``.

    from repro_torch import paper_figures
    rows = paper_figures.fig3(device="cpu")   # rows[-1]: the statistics
"""
from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np

from .core import embed, power, solvers, topology, vsr
from .core.api import PlacementSpec
from .core.power import Device

POLICIES = ("cdc", "af", "mf", "cfn-milp")
GAP_METHODS = ("coordinate", "anneal", "genetic", "relax", "cfn-milp")

OutDir = Union[str, Path, None]


def _write(out_dir: OutDir, name: str, rows: List[Dict]) -> None:
    if out_dir is None or not rows:
        return
    path = Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    with (path / f"{name}.csv").open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _solve(topo, vs, method: str, problem, seed: int = 0):
    return embed.embed(topo, vs, PlacementSpec(method=method),
                       gen=solvers.default_generator(seed), problem=problem)


def fig3(max_vsrs: int = 20, seed: int = 0, device: Device = None,
         out_dir: OutDir = None) -> List[Dict]:
    """Total power vs #VSRs for the four placement policies; the last row
    (``n_vsrs`` -1) holds the savings statistics.  The n-VSR scenario is
    the prefix of one draw of ``max_vsrs`` requests (the paper's growing
    workload), so the IoT layer saturates at the end.  The layers the
    optimizer used come from the same cfn-milp solve (the JAX driver
    solves it again with the same seed and gets the same placement)."""
    topo = topology.paper_topology()
    substrate = power.substrate_arrays(topo, device)
    rows, savings = [], []
    all_vs = vsr.random_vsrs(max_vsrs, rng=seed, source_nodes=[0])
    for n in range(1, max_vsrs + 1):
        vs = vsr.VSRBatch(F=all_vs.F[:n], H=all_vs.H[:n],
                          src=all_vs.src[:n], input_vm=all_vs.input_vm[:n])
        problem = power.build_problem(topo, vs, substrate=substrate)
        rec: Dict = dict(n_vsrs=n)
        for pol in POLICIES:
            res = _solve(topo, vs, pol, problem, seed=n)
            rec[f"{pol}_w"] = round(res.power, 2)
            rec[f"{pol}_feasible"] = res.feasible
        rec["saving_vs_cdc"] = round(1 - rec["cfn-milp_w"] / rec["cdc_w"], 4)
        savings.append(rec["saving_vs_cdc"])
        layers = sorted({topo.proc_layer[p] for p in res.X.reshape(-1)})
        rec["layers_used"] = "+".join(layers)
        rows.append(rec)
    _write(out_dir, "fig3_total_power", rows)
    stats = dict(rows[0])   # the summary row, after the CSV write
    stats.update(n_vsrs=-1, layers_used="STATS",
                 saving_vs_cdc=round(float(np.mean(savings)), 4),
                 saving_min=round(float(np.min(savings)), 4),
                 saving_max=round(float(np.max(savings)), 4))
    rows.append(stats)
    return rows


def fig4(n_vsrs: int = 10, seed: int = 0, device: Device = None,
         out_dir: OutDir = None) -> List[Dict]:
    """Network vs processing power decomposition (paper Fig. 4)."""
    topo = topology.paper_topology()
    vs = vsr.random_vsrs(n_vsrs, rng=seed, source_nodes=[0])
    problem = power.build_problem(topo, vs, device=device)
    rows = []
    for pol in POLICIES:
        res = _solve(topo, vs, pol, problem)
        summary = power.summarize(problem, topo, res.X)
        rows.append(dict(policy=pol, net_w=round(summary["net_w"], 2),
                         proc_w=round(summary["proc_w"], 2),
                         total_w=round(summary["total_w"], 2),
                         gflops_iot=round(summary["gflops_iot"], 1),
                         gflops_af=round(summary["gflops_af"], 1),
                         gflops_mf=round(summary["gflops_mf"], 1),
                         gflops_cdc=round(summary["gflops_cdc"], 1)))
    _write(out_dir, "fig4_decomposition", rows)
    return rows


def solver_gap(seeds: Sequence[int] = (0, 1, 2, 3, 4), device: Device = None,
               out_dir: OutDir = None) -> List[Dict]:
    """Optimality gap of every solver vs exhaustive enumeration (2 VSRs of
    2 VMs on a 4-IoT, 2-zone paper substrate), with each solve's seconds
    (host clock; on the card each solve ends in a device-to-host copy of
    its placement)."""
    rows = []
    topo = topology.paper_topology(n_iot=4, n_zones=2)
    for seed in seeds:
        vs = vsr.random_vsrs(2, rng=seed, n_vms=2, source_nodes=[0])
        problem = power.build_problem(topo, vs, device=device)
        t0 = time.perf_counter()
        best = solvers.exhaustive(problem)
        rec = dict(seed=seed, exhaustive_w=round(best.power, 3),
                   exhaustive_s=time.perf_counter() - t0)
        for method in GAP_METHODS:
            t0 = time.perf_counter()
            res = _solve(topo, vs, method, problem, seed=seed)
            rec[f"{method}_gap"] = round(
                (res.objective - best.objective)
                / max(best.objective, 1e-9), 5)
            rec[f"{method}_s"] = time.perf_counter() - t0
        rows.append(rec)
    _write(out_dir, "solver_gap", rows)
    return rows

