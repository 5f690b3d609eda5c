"""Placement solvers for the CFN embedding problem (batch path, torch).

The suite of the JAX package, on power.py's delta engine and the CUDA
kernels of ``kernels``:

  fixed_layer     -- the paper's CDC / AF / MF baselines (+ IoT first-fit).
  coordinate      -- exact best-single-move sweeps via delta_sweep (monotone).
  exhaustive      -- provably optimal joint enumeration (small instances).
  anneal          -- Metropolis chains on incremental state: ``delta``
                     (PyTorch loop), ``fused`` (the fused CUDA kernel; its
                     plain version on the CPU), ``full`` (full objective per
                     step, the baseline).
  genetic         -- population crossover/mutation search.
  relax           -- softmax relaxation on the soft power surrogate, Adam
                     descent on autograd, argmax + coordinate repair.
  solve_portfolio -- spec-driven best-of portfolio, the "CFN MILP" stand-in.
  resolve_incremental -- warm-start re-solve after service churn (targeted
                     sweeps, a short delta anneal, a kernel re-score of the
                     candidates, polish sweeps): the online engine's event.
  resolve_wave    -- the same, once for a whole churn wave.

Every solver takes an optional ``eligible`` [R, P] mask (the constraint
surface ``api.PlacementSpec.masks`` produces).  Random draws come from an
explicit ``torch.Generator`` (CPU), so runs are reproducible; the
stochastic loops also take their proposal streams as inputs, which is how
the tests feed them the JAX package's streams.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as _pytree

from .power import (PlacementAux, PlacementProblem, PlacementState,
                    PowerBreakdown, _delta_objective, _move_core, apply_move,
                    apply_pins, as_placement, batched_hard_loads, build_aux,
                    delta_sweep, evaluate, init_state, objective,
                    objective_batch, to_tensor)
from .topology import CFNTopology


@dataclass
class SolveResult:
    X: np.ndarray                 # [R, V] placement (pins applied)
    breakdown: PowerBreakdown     # numpy fields
    method: str
    history: List[float] = field(default_factory=list)
    # convergence trace (record_conv=True on the delta anneal path):
    # {"best_obj": [n_steps], "accept_rate": [n_steps]}
    conv: Optional[Dict[str, np.ndarray]] = None

    @property
    def objective(self) -> float:
        return float(self.breakdown.objective)

    @property
    def power(self) -> float:
        return float(self.breakdown.total)

    @property
    def feasible(self) -> bool:
        return float(self.breakdown.violation) <= 1e-6


# Fresh-shape counters of the counted solver entries: the port compiles
# nothing at run time, so ``TRACE_COUNTS[name]`` ticks once per abstract
# shape fingerprint an entry sees in the process -- exactly the set a jit
# cache (the JAX package's ``count_traces``) would trace.
TRACE_COUNTS: Dict[str, int] = {}

# Shape-attribution hooks (``repro_torch.telemetry``): called once per fresh
# fingerprint with (entry name, abstract shape fingerprint).
TRACE_HOOKS: List = []

_TRACE_SEEN: Dict[str, set] = {}
_FINGERPRINT_MAX_LEAVES = 16


def clear_trace_cache() -> None:
    """Forget every fingerprint seen (``jax.clear_caches`` for the
    counted entries): each entry's next shape counts as fresh again."""
    _TRACE_SEEN.clear()


def _leaves(a) -> list:
    """Pytree leaves of an argument; a dataclass (``PlacementProblem``)
    by its fields, so cached views never change its fingerprint."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return [getattr(a, f.name) for f in dataclasses.fields(a)
                if getattr(a, f.name) is not None]
    return [x for x in _pytree.tree_leaves(a) if x is not None]


def _trace_fingerprint(args, kwargs) -> str:
    """Abstract shape fingerprint of a counted call's arguments: per leaf
    ``dtype[shape]`` (``.shape`` / ``.dtype`` reads only), scalars by
    repr, other statics by type name; at most
    ``_FINGERPRINT_MAX_LEAVES`` leaves an argument."""
    parts = []
    for a in list(args) + [kwargs[k] for k in sorted(kwargs)]:
        leaves = _leaves(a)
        if not leaves:
            parts.append("()" if a is None else type(a).__name__)
            continue
        sub = []
        for leaf in leaves[:_FINGERPRINT_MAX_LEAVES]:
            shp = getattr(leaf, "shape", None)
            if shp is not None:
                dt = str(getattr(leaf, "dtype", "?")).replace("torch.", "")
                sub.append(f"{dt}[{','.join(str(d) for d in shp)}]")
            else:
                sub.append(repr(leaf) if isinstance(
                    leaf, (bool, int, float, str)) else type(leaf).__name__)
        if len(leaves) > _FINGERPRINT_MAX_LEAVES:
            sub.append(f"+{len(leaves) - _FINGERPRINT_MAX_LEAVES}")
        tag = type(a).__name__
        parts.append("x".join(sub) if tag in ("Tensor", "ndarray")
                     and len(sub) == 1 else f"{tag}({','.join(sub)})")
    return ";".join(parts)


def count_traces(name: str):
    """Mark a counted solver entry: ``TRACE_COUNTS[name]`` ticks once per
    fresh abstract shape fingerprint of its arguments, not per call, and
    every hook in ``TRACE_HOOKS`` sees (name, fingerprint) then."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            fp = _trace_fingerprint(args, kwargs)
            mine = _TRACE_SEEN.setdefault(name, set())
            if fp not in mine:
                mine.add(fp)
                TRACE_COUNTS[name] = TRACE_COUNTS.get(name, 0) + 1
                for hook in list(TRACE_HOOKS):
                    hook(name, fp)
            return fn(*args, **kwargs)
        return wrapper
    return deco


def default_generator(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _result(problem: PlacementProblem, X, method: str,
            history: Optional[List[float]] = None) -> SolveResult:
    Xp = apply_pins(problem, X)
    bd = evaluate(problem, Xp)
    return SolveResult(X=Xp.cpu().numpy(),
                       breakdown=PowerBreakdown(
                           *(t.cpu().numpy() for t in bd)),
                       method=method, history=history or [])


# ---------------------------------------------------------------------------
# Fixed-layer baselines (paper Fig. 3 scenarios)
# ---------------------------------------------------------------------------

def fixed_layer(problem: PlacementProblem, topo: CFNTopology,
                layer: str, spill_layer: str = "cdc") -> SolveResult:
    """All non-input VMs at `layer`; first-fit-decreasing across that layer's
    nodes honoring GFLOPS capacity; overflow spills to ``spill_layer``
    (the paper's observed behaviour at 20 VSRs)."""
    nodes = topo.layer_indices(layer)
    spill = topo.layer_indices(spill_layer)
    # host-side FFD accounting
    cap = np.array([topo.proc_hw[p].cap_gflops * topo.proc_hw[p].n_servers
                    for p in range(topo.P)],
                   dtype=np.float64)  # tracelint: allow[CFN102]
    load = np.zeros(topo.P)
    F = problem.F.cpu().numpy()
    fixed_mask = problem.fixed_mask.cpu().numpy()
    fixed_node = problem.fixed_node.cpu().numpy()
    R, V = F.shape
    # account pinned input VMs first
    for r in range(R):
        for v in range(V):
            if fixed_mask[r, v]:
                load[fixed_node[r, v]] += F[r, v]
    X = np.zeros((R, V), dtype=np.int32)
    order = sorted(((r, v) for r in range(R) for v in range(V)
                    if not fixed_mask[r, v]),
                   key=lambda rv: -F[rv])
    for (r, v) in order:
        placed = False
        for p in sorted(nodes, key=lambda p: load[p]):
            if load[p] + F[r, v] <= cap[p] + 1e-9:
                X[r, v] = p
                load[p] += F[r, v]
                placed = True
                break
        if not placed:
            for p in sorted(spill, key=lambda p: load[p]):
                if load[p] + F[r, v] <= cap[p] + 1e-9:
                    X[r, v] = p
                    load[p] += F[r, v]
                    placed = True
                    break
        if not placed:  # genuinely infeasible; dump on first node
            X[r, v] = nodes[0]
            load[nodes[0]] += F[r, v]
    return _result(problem, X, f"fixed:{layer}")


# ---------------------------------------------------------------------------
# Eligibility masks
# ---------------------------------------------------------------------------

# objective placeholder for masked-out (SLA-ineligible) destinations: large
# enough to lose every argmin, small enough to stay finite in float32 sums
_INELIGIBLE = 1.0e30


def _eligible_np(eligible: Optional[np.ndarray]):
    """Normalize an [R, P] eligibility mask for the solver paths.

    Returns ``(el, cnt, cand)``: the bool mask with no-eligible-node rows
    fallen back to all-True, per-row eligible counts [R], and the per-row
    candidate table [R, P] (eligible node ids left-packed) that Metropolis
    destination sampling draws from.  ``(None, None, None)`` when unmasked.
    """
    if eligible is None:
        return None, None, None
    el = np.asarray(eligible, bool).copy()
    dead = ~el.any(axis=1)
    el[dead] = True
    cnt = el.sum(axis=1).astype(np.int32)
    cand = np.zeros(el.shape, np.int32)
    for r in range(el.shape[0]):
        ids = np.nonzero(el[r])[0]
        cand[r, :len(ids)] = ids
    return el, cnt, cand


def _sample_eligible(u: torch.Tensor, rows: torch.Tensor,
                     cnt: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Map uniform draws ``u`` to eligible destination nodes for service
    rows ``rows`` (broadcast against ``u``) -- the one sampling map behind
    every masked random draw."""
    c = cnt[rows]
    idx = torch.minimum((u * c).to(torch.int32), c - 1)
    return cand[rows, idx.long()]


def _project_eligible(problem: PlacementProblem, X,
                      el_np: np.ndarray) -> Tuple[torch.Tensor, bool]:
    """Move every free VM sitting on an ineligible node to its row's first
    eligible node.  Returns ``(X_proj, moved)``; ``moved`` is a host-side
    bool computed from the numpy mask."""
    Xn = np.asarray(X.cpu().numpy() if torch.is_tensor(X) else X).copy()
    fixed = problem.fixed_mask.cpu().numpy()
    first = el_np.argmax(axis=1).astype(Xn.dtype)
    rows = np.arange(Xn.shape[0])[:, None]
    bad = ~el_np[rows, Xn] & ~fixed
    proj = as_placement(problem, np.where(bad, first[:, None], Xn))
    return proj, bool(bad.any())


# ---------------------------------------------------------------------------
# Coordinate descent (exact single-VM moves, scored by the delta engine)
# ---------------------------------------------------------------------------

def _sweep_step(problem: PlacementProblem, aux: PlacementAux, state, r, v,
                eligible: Optional[torch.Tensor] = None):
    """One coordinate move: VM (r, v) to its best node (``delta_sweep``
    scores every destination at once; ``eligible`` [R, P] masks them per
    service row).  ``r`` / ``v`` are ints, or int tensors where the
    region-batched sweep (``core/federation.py``) vmaps this step.
    Returns the new state and the best objective."""
    obj_all = delta_sweep(problem, aux, state, r, v)
    if eligible is not None:
        obj_all = torch.where(eligible[r], obj_all,
                              torch.full_like(obj_all, _INELIGIBLE))
    best = torch.argmin(obj_all)
    return apply_move(problem, aux, state, r, v, best), obj_all[best]


@count_traces("sweep")
def _sweep(problem: PlacementProblem, aux: PlacementAux, state,
           positions: np.ndarray, eligible: Optional[torch.Tensor] = None):
    """One pass over the given free VM positions [M, 2] (``_sweep_step``
    each).  Returns the new state and the last position's best
    objective."""
    last = None
    for r, v in positions.tolist():
        state, last = _sweep_step(problem, aux, state, r, v, eligible)
    return state, last


def coordinate(problem: PlacementProblem, X0,
               max_sweeps: int = 12, tol: float = 1e-6,
               eligible: Optional[np.ndarray] = None) -> SolveResult:
    """Exact best-single-move sweeps.  ``eligible`` [R, P] (optional) masks
    each service row's destination nodes in every sweep argmin; X0 need not
    satisfy the mask (the first sweep moves every free VM onto it, and the
    incumbent is only ever taken from post-sweep states)."""
    aux = build_aux(problem)
    el_np, _, _ = _eligible_np(eligible)
    el_t = None if el_np is None else torch.as_tensor(el_np,
                                                      device=problem.device)
    positions = aux.free_pos.cpu().numpy()
    if positions.shape[0] == 0:  # every VM pinned: nothing to move
        return _result(problem, X0, "coordinate")
    state = init_state(problem, X0)
    # a masked solve may not trust an (ineligible) warm start as incumbent
    best_obj = float("inf") if el_np is not None else float(state.obj)
    best_X = state.X
    history: List[float] = []
    for _ in range(max_sweeps):
        state, _ = _sweep(problem, aux, state, positions, el_t)
        # exact refresh once per sweep: kills float32 drift and yields an
        # exact (incumbent-best, hence monotone) history
        state = init_state(problem, state.X)
        obj = float(state.obj)
        if obj < best_obj:
            best_obj, best_X = obj, state.X
        history.append(best_obj)
        if len(history) > 1 and history[-2] - obj < tol:
            break
    return _result(problem, best_X, "coordinate", history)


# ---------------------------------------------------------------------------
# Exhaustive enumeration (ground truth on small instances)
# ---------------------------------------------------------------------------

def exhaustive(problem: PlacementProblem, max_combos: int = 2_000_000,
               chunk: int = 8192,
               eligible: Optional[np.ndarray] = None) -> SolveResult:
    from ..kernels import ops as kops
    fixed_mask = problem.fixed_mask.cpu().numpy()
    free = np.argwhere(~fixed_mask)
    P = problem.P
    n_free = len(free)
    n_combos = P ** n_free
    if n_combos > max_combos:
        raise ValueError(f"{n_combos} combos exceed cap {max_combos}")
    el_np, _, _ = _eligible_np(eligible)
    R, V = fixed_mask.shape
    base = np.zeros((R, V), dtype=np.int32)
    best_obj, best_X = float("inf"), base
    for start in range(0, n_combos, chunk):
        idx = np.arange(start, min(start + chunk, n_combos))
        digits = np.empty((len(idx), n_free), dtype=np.int32)
        rem = idx.copy()
        for j in range(n_free - 1, -1, -1):
            digits[:, j] = rem % P
            rem //= P
        Xb = np.broadcast_to(base, (len(idx), R, V)).copy()
        Xb[:, free[:, 0], free[:, 1]] = digits
        obj = kops.placement_objective(problem, Xb)[:, 0].cpu().numpy()
        if el_np is not None:
            valid = el_np[free[None, :, 0], digits].all(axis=1)
            obj = np.where(valid, obj, np.inf)
        k = int(np.argmin(obj))
        if obj[k] < best_obj:
            best_obj, best_X = float(obj[k]), Xb[k]
    if not np.isfinite(best_obj):
        raise ValueError("no placement satisfies the eligibility mask")
    return _result(problem, best_X, "exhaustive", [best_obj])


# ---------------------------------------------------------------------------
# Batched simulated annealing
# ---------------------------------------------------------------------------

def _chain_step(problem: PlacementProblem, aux: PlacementAux,
                Xf, omega, theta, lam, obj, j, p_new):
    """One Metropolis proposal on each of C chains' incremental state
    (Xf [C, J], omega/theta [C, P], lam [C, N], obj [C]; j/p_new [C]).
    Returns the candidate states + exact objective deltas; the caller
    decides acceptance."""
    _, idx, om2, th2, lm2, _ = _move_core(problem, aux, Xf, omega, theta,
                                          lam, j, p_new)
    delta = _delta_objective(problem, omega, theta, lam, idx, om2, th2, lm2)
    Xf2 = Xf.scatter(1, j[:, None], p_new[:, None].to(Xf.dtype))
    return (Xf2, omega.scatter(1, idx, om2), theta.scatter(1, idx, th2),
            lm2, obj + delta, delta)


def _anneal_proposals(gen: torch.Generator, aux: PlacementAux,
                      n_steps: int, n_chains: int, P: int,
                      V: Optional[int] = None,
                      cnt: Optional[np.ndarray] = None,
                      cand: Optional[np.ndarray] = None,
                      streams: Optional[tuple] = None):
    """Free-position Metropolis proposals ``(fi, p_prop, u)``, each
    [n_steps, n_chains]: index into ``aux.free_pos``, destination node,
    uniform draw.

    Pinned input VMs are never proposed.  With ``cnt``/``cand`` (an
    eligibility table from ``_eligible_np``) destinations are sampled from
    the proposed VM's row-eligible set only.  ``streams`` injects the three
    arrays instead of drawing them (any array type; e.g. the JAX package's
    streams in the parity tests).  Returned on the aux tensors' device."""
    dev = aux.free_flat.device
    if streams is not None:
        fi, p_prop, u = (to_tensor(np.asarray(s), dev) for s in streams)
        return fi.long(), p_prop.to(torch.int32), u.to(torch.float32)
    M = aux.free_pos.shape[0]
    fi = torch.randint(0, M, (n_steps, n_chains), generator=gen).to(dev)
    if cnt is None:
        p_prop = torch.randint(0, P, (n_steps, n_chains), generator=gen,
                               dtype=torch.int32).to(dev)
    else:
        rows = aux.free_flat[fi].long() // V
        u_dst = torch.rand((n_steps, n_chains), generator=gen).to(dev)
        p_prop = _sample_eligible(u_dst, rows, torch.as_tensor(cnt, device=dev),
                                  torch.as_tensor(cand, device=dev))
    u = torch.rand((n_steps, n_chains), generator=gen).to(dev)
    return fi, p_prop.to(torch.int32), u


def _temps(n_steps: int, t0: float, t1: float, device) -> torch.Tensor:
    steps = torch.arange(n_steps, dtype=torch.float32, device=device)
    return t0 * (t1 / t0) ** (steps / max(1, n_steps - 1))


def anneal(problem: PlacementProblem, gen: Optional[torch.Generator], X0,
           n_chains: int = 32, n_steps: int = 4000,
           t0: float = 50.0, t1: float = 0.05,
           backend: str = "auto",
           eligible: Optional[np.ndarray] = None,
           record_conv: bool = False,
           proposals: Optional[tuple] = None,
           restarts=None) -> SolveResult:
    """Batched Metropolis chains on incremental (delta-evaluated) state.

    backend:
      * ``"delta"`` -- PyTorch loop over steps, chains batched; per-chain
        loads updated entry-wise per step.
      * ``"fused"`` -- ``kernels.ops.fused_anneal``: the fused CUDA kernel
        (one launch for the whole schedule) on a CUDA problem, its plain
        version on the CPU.  The chains' best placements are re-scored
        exactly (``ops.placement_objective``) to pick the winner.
      * ``"full"``  -- full ``objective_batch`` per step (the baseline).
      * ``"auto"``  -- fused when the problem lives on CUDA and a variant of
        the kernel takes its shape, delta elsewhere.  The choice is
        ``kernels.placement_power.fused_anneal_variant``'s, made before any
        launch: on the card it is "delta" for D > 32 incident links a VM or
        2 * D * K > 1024 route slots (the result's method is then
        ``"anneal"``, not ``"anneal(fused)"``).  An explicit ``"fused"``
        raises for those shapes.

    Chain 0 starts at the warm start ``X0``; the others restart at random
    placements.  ``eligible`` [R, P] projects the warm start, samples the
    restarts and draws every proposal from the mask.  ``proposals``
    injects ``(fi, p_prop, u)`` streams (see ``_anneal_proposals``) and
    ``restarts`` [n_chains, R, V] the chains' random starting placements
    (chain 0's gives way to the warm start), as the tests inject the JAX
    package's draws.
    ``record_conv=True`` attaches the per-step convergence trace (delta
    and full backends).
    """
    from ..kernels import ops as kops, placement_power as kpp
    R, V, P = problem.R, problem.V, problem.P
    dev = problem.device
    if backend not in ("auto", "delta", "fused", "full"):
        raise ValueError(f"unknown anneal backend {backend!r}")
    aux = build_aux(problem)
    if backend == "auto":
        backend = "delta"
        if dev.type == "cuda" and kpp.fused_anneal_variant(
                n_chains, R * V, P, problem.N, aux.inc_h.shape[1],
                problem.K)[0] != "delta":
            backend = "fused"
    if aux.free_pos.shape[0] == 0:
        # every VM is pinned (e.g. single-VM VSRs): nothing to anneal
        return _result(problem, X0, "anneal")
    gen = default_generator() if gen is None else gen
    el_np, cnt_np, cand_np = _eligible_np(eligible)
    X = apply_pins(problem, X0)
    if el_np is not None:
        Xp, _ = _project_eligible(problem, X, el_np)
        X = apply_pins(problem, Xp)
    Xc = X.expand(n_chains, R, V)
    # randomize all but chain 0 (keep one chain at the warm start)
    if restarts is not None:
        rand = to_tensor(np.asarray(restarts), dev, torch.int32)
    elif el_np is None:
        rand = torch.randint(0, P, (n_chains, R, V), generator=gen,
                             dtype=torch.int32).to(dev)
    else:
        u_r = torch.rand((n_chains, R, V), generator=gen).to(dev)
        rand = _sample_eligible(
            u_r, torch.arange(R, device=dev)[None, :, None],
            torch.as_tensor(cnt_np, device=dev),
            torch.as_tensor(cand_np, device=dev)).to(torch.int32)
    keep = (torch.arange(n_chains, device=dev) == 0)[:, None, None]
    Xc = apply_pins(problem, torch.where(keep, Xc, rand))

    temps = _temps(n_steps, t0, t1, dev)
    fi, p_prop, u_prop = _anneal_proposals(gen, aux, n_steps, n_chains, P,
                                           V=V, cnt=cnt_np, cand=cand_np,
                                           streams=proposals)
    j_prop = aux.free_flat[fi]                            # [n_steps, n_chains]

    if backend == "fused":
        el_t = None if el_np is None else torch.as_tensor(el_np, device=dev)
        bXc, _ = kops.fused_anneal(problem, aux, Xc, j_prop.T, p_prop.T,
                                   u_prop.T, temps, eligible=el_t)
        objs = kops.placement_objective(problem, bXc)[:, 0]
        k = int(torch.argmin(objs))
        return _result(problem, bXc[k], "anneal(fused)", [float(objs[k])])
    if backend == "full":
        bX, _, hist = _anneal_scan_full(problem, Xc, j_prop, p_prop, u_prop,
                                        temps)
    else:
        bX, _, hist = _anneal_scan_delta(problem, aux, Xc, j_prop, p_prop,
                                         u_prop, temps)
    tag = "anneal" if backend == "delta" else f"anneal({backend})"
    best_hist = hist[0].cpu().numpy()
    res = _result(problem, bX, tag,
                  [float(h) for h in best_hist[:: max(1, n_steps // 50)]])
    if record_conv:
        res.conv = {"best_obj": best_hist,
                    "accept_rate": hist[1].cpu().numpy()}
    return res


def _accept(delta, u, T):
    return (delta < 0) | (u < torch.exp(-torch.clamp_min(delta, 0.0)
                                        / torch.clamp_min(T, 1e-9)))


@count_traces("anneal_delta")
def _anneal_scan_delta(problem: PlacementProblem, aux: PlacementAux,
                       Xc, j_prop, p_prop, u_prop, temps):
    """Metropolis chains on incremental per-chain load state.

    Xc [C, R, V] starting placements (pins applied); j_prop/p_prop/u_prop
    [T, C]; temps [T].  Returns ``(best X [R, V], best objective [],
    (best_obj [T], accept_rate [T]))``."""
    dev = problem.device
    Xc = as_placement(problem, Xc)
    n_chains, R, V = Xc.shape
    Xf = Xc.reshape(n_chains, -1)
    omega, theta, lam, obj = batched_hard_loads(problem, Xc)
    j_prop = to_tensor(j_prop, dev, torch.long)
    p_prop = to_tensor(p_prop, dev, torch.long)
    u_prop = to_tensor(u_prop, dev, torch.float32)
    temps = to_tensor(temps, dev, torch.float32)
    bX, bobj = Xf, obj
    best_t, acc_t = [], []
    for t in range(temps.shape[0]):
        Xf2, om2, th2, lm2, obj2, delta = _chain_step(
            problem, aux, Xf, omega, theta, lam, obj, j_prop[t], p_prop[t])
        acc = _accept(delta, u_prop[t], temps[t])
        a1 = acc[:, None]
        Xf = torch.where(a1, Xf2, Xf)
        omega = torch.where(a1, om2, omega)
        theta = torch.where(a1, th2, theta)
        lam = torch.where(a1, lm2, lam)
        obj = torch.where(acc, obj2, obj)
        better = obj < bobj
        bX = torch.where(better[:, None], Xf, bX)
        bobj = torch.where(better, obj, bobj)
        best_t.append(bobj.min())
        acc_t.append(acc.float().mean())
    k = torch.argmin(bobj)
    return (bX[k].reshape(R, V), bobj[k],
            (torch.stack(best_t), torch.stack(acc_t)))


@count_traces("anneal_full")
def _anneal_scan_full(problem: PlacementProblem, Xc, j_prop, p_prop,
                      u_prop, temps):
    """Annealing with one full batched objective per Metropolis step (the
    baseline the delta and fused paths are measured against)."""
    Xc = as_placement(problem, Xc)
    n_chains = Xc.shape[0]
    obj = objective_batch(problem, Xc)
    bX, bobj = Xc, obj
    ci = torch.arange(n_chains, device=problem.device)
    best_t, acc_t = [], []
    for t in range(temps.shape[0]):
        Xp = Xc.reshape(n_chains, -1).clone()
        Xp[ci, j_prop[t].long()] = p_prop[t].to(Xp.dtype)
        Xp = Xp.reshape(Xc.shape)
        objp = objective_batch(problem, Xp)
        acc = (objp < obj) | (u_prop[t] < torch.exp(-(objp - obj)
                                                     / temps[t]))
        Xc = torch.where(acc[:, None, None], Xp, Xc)
        obj = torch.where(acc, objp, obj)
        better = obj < bobj
        bX = torch.where(better[:, None, None], Xc, bX)
        bobj = torch.where(better, obj, bobj)
        best_t.append(bobj.min())
        acc_t.append(acc.float().mean())
    k = torch.argmin(bobj)
    return bX[k], bobj[k], (torch.stack(best_t), torch.stack(acc_t))


# ---------------------------------------------------------------------------
# Genetic search
# ---------------------------------------------------------------------------

def genetic(problem: PlacementProblem, gen: Optional[torch.Generator], X0,
            pop: int = 64, gens: int = 300, p_mut: float = 0.08,
            eligible: Optional[np.ndarray] = None) -> SolveResult:
    """Population search (tournament selection, per-service uniform
    crossover with a shifted copy, mutation, elitism).  ``eligible`` [R, P]
    (optional): the elite is projected onto the mask and the initial
    population and every mutation are sampled from it, so every individual
    ever evaluated is eligible."""
    from ..kernels import ops as kops
    R, V, P = problem.R, problem.V, problem.P
    dev = problem.device
    gen = default_generator() if gen is None else gen
    el_np, cnt_np, cand_np = _eligible_np(eligible)
    elite = as_placement(problem, X0)
    rows = torch.arange(R, device=dev)[None, :, None]

    def draw_nodes(shape):
        if el_np is None:
            return torch.randint(0, P, shape, generator=gen,
                                 dtype=torch.int32).to(dev)
        u = torch.rand(shape, generator=gen).to(dev)
        return _sample_eligible(u, rows, cnt_t, cand_t).to(torch.int32)

    if el_np is not None:
        elite, _ = _project_eligible(problem, elite, el_np)
        cnt_t = torch.as_tensor(cnt_np, device=dev)
        cand_t = torch.as_tensor(cand_np, device=dev)
    Xp = draw_nodes((pop, R, V))
    Xp[0] = elite
    fitness = lambda X: kops.placement_objective(problem, X)[:, 0]
    hist = []
    for _ in range(gens):
        fit = fitness(Xp)
        a = torch.randint(0, pop, (pop,), generator=gen).to(dev)
        b = torch.randint(0, pop, (pop,), generator=gen).to(dev)
        parents = torch.where((fit[a] < fit[b])[:, None, None], Xp[a], Xp[b])
        mask = (torch.rand((pop, R), generator=gen) < 0.5).to(dev)[:, :, None]
        children = torch.where(mask, parents, torch.roll(parents, 1, 0))
        mut = (torch.rand((pop, R, V), generator=gen) < p_mut).to(dev)
        children = torch.where(mut, draw_nodes((pop, R, V)), children)
        best = torch.argmin(fit)
        children[0] = Xp[best]
        hist.append(fit[best])
        Xp = children
    fit = fitness(Xp)
    k = int(torch.argmin(fit))
    hist = torch.stack(hist).cpu().numpy()
    return _result(problem, Xp[k], "genetic",
                   [float(h) for h in hist[:: max(1, gens // 50)]])


# ---------------------------------------------------------------------------
# Differentiable relaxation
# ---------------------------------------------------------------------------

PENALTY_W = 100.0  # relative weight of violation in the relaxed loss


def relax(problem: PlacementProblem, gen: Optional[torch.Generator] = None,
          steps: int = 800, lr: float = 0.3,
          temp0: float = 5.0, temp1: float = 0.05,
          eligible: Optional[np.ndarray] = None,
          logits0=None) -> SolveResult:
    """Soft placement: logits -> softmax assignment, smooth power surrogate
    (``evaluate(hard=False)``), Adam descent with an annealed temperature,
    then argmax + a 4-sweep coordinate repair.  ``eligible`` [R, P]
    (optional) biases ineligible nodes' logits by -1e9 (zero probability
    mass) and masks the repair.

    The starting logits are ``0.01 * randn((R, V, P), generator=gen)``
    unless ``logits0`` [R, V, P] is given (the tests pass the JAX
    package's own draw).  The gradient comes from autograd; the Adam steps
    are written out as the JAX package writes them (b1 0.9, b2 0.999, eps
    1e-8, bias correction at step i + 1).  ``history`` holds the loss
    every ``steps // 40`` steps, then the repair's history."""
    R, V, P = problem.R, problem.V, problem.P
    dev = problem.device
    if logits0 is None:
        gen = default_generator() if gen is None else gen
        logits0 = 0.01 * torch.randn((R, V, P), generator=gen)
    logits = to_tensor(logits0, dev, torch.float32)
    el_np, _, _ = _eligible_np(eligible)
    bias = (0.0 if el_np is None else torch.where(
        torch.as_tensor(el_np, device=dev)[:, None, :], 0.0, -1e9))

    def loss_fn(logits, temp):
        soft = torch.softmax((logits + bias) / max(temp, 1e-3), dim=-1)
        bd = evaluate(problem, soft, hard=False, temp=temp)
        # entropy push towards one-hot as temp decays
        ent = -(soft * torch.log(soft + 1e-9)).sum(-1).mean()
        return bd.total + 10.0 * PENALTY_W * bd.violation + 0.1 * ent

    m = torch.zeros_like(logits)
    v = torch.zeros_like(logits)
    b1, b2, eps = 0.9, 0.999, 1e-8
    history = []
    for i in range(steps):
        temp = temp0 * (temp1 / temp0) ** (i / max(1, steps - 1))
        leaf = logits.detach().requires_grad_(True)
        loss = loss_fn(leaf, temp)
        g, = torch.autograd.grad(loss, leaf)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (i + 1))
        vh = v / (1 - b2 ** (i + 1))
        logits = logits - lr * mh / (torch.sqrt(vh) + eps)
        if i % max(1, steps // 40) == 0:
            history.append(float(loss.detach()))
    X = torch.argmax(logits + bias, dim=-1).to(torch.int32)
    res = coordinate(problem, X, max_sweeps=4, eligible=eligible)
    return SolveResult(X=res.X, breakdown=res.breakdown, method="relax",
                       history=history + res.history)


# ---------------------------------------------------------------------------
# Portfolio solver: the "CFN (MILP)" stand-in
# ---------------------------------------------------------------------------

def solve_portfolio(problem: PlacementProblem, topo: CFNTopology,
                    spec=None, gen: Optional[torch.Generator] = None,
                    eligible: Optional[np.ndarray] = None) -> SolveResult:
    """Best-of portfolio driven by an ``api.PlacementSpec``: effort tier,
    anneal backend and constraint masks come from the spec (``eligible``
    overrides ``spec.masks(problem)`` when given).

    "quick": coordinate sweeps from the CDC-everything and IoT-first-fit
    warm starts; "standard": + a 4000-step anneal from the better of them;
    "high": + 12000 steps and genetic search.
    """
    gen = default_generator() if gen is None else gen
    effort = getattr(spec, "effort", "standard")
    backend = getattr(spec, "backend", "auto")
    if eligible is None and spec is not None:
        eligible = spec.masks(problem)
    cdc = topo.layer_indices("cdc")[0]
    candidates: List[SolveResult] = []
    base_cdc = np.full((problem.R, problem.V), cdc, dtype=np.int32)
    candidates.append(coordinate(problem, base_cdc, eligible=eligible))
    iot_ff = fixed_layer(problem, topo, "iot")
    candidates.append(coordinate(problem, iot_ff.X, eligible=eligible))
    if effort in ("standard", "high"):
        warm = min(candidates, key=lambda r: r.objective).X
        n_steps = 4000 if effort == "standard" else 12000
        candidates.append(anneal(problem, gen, warm, n_steps=n_steps,
                                 backend=backend, eligible=eligible))
        if effort == "high":
            candidates.append(genetic(problem, gen, warm, eligible=eligible))
    best = min(candidates, key=lambda r: r.objective)
    return SolveResult(X=best.X, breakdown=best.breakdown,
                       method=f"cfn-milp({best.method})", history=best.history)


def solve_cfn(problem: PlacementProblem, topo: CFNTopology,
              gen: Optional[torch.Generator] = None,
              effort: str = "standard") -> SolveResult:
    """Deprecated shim: builds a ``PlacementSpec(effort=effort)`` and routes
    through ``solve_portfolio`` (use ``repro_torch.api.CFNSession`` or
    ``solve_portfolio`` directly); the results are ``solve_portfolio``'s."""
    from . import api
    warnings.warn(
        "solve_cfn() is deprecated; build a repro_torch.api.PlacementSpec "
        "and call solve_portfolio() (or use repro_torch.api.CFNSession)",
        DeprecationWarning, stacklevel=2)
    return solve_portfolio(problem, topo, api.PlacementSpec(effort=effort),
                           gen)


def _pow2(n: int, lo: int = 2) -> int:
    """Next power-of-two bucket >= max(n, 1): the one bucketing policy of
    the row/column padding (``api.CFNSession``)."""
    n = max(n, 1)
    b = lo
    while b < n:
        b *= 2
    return b


# The region-batched portfolio (stack_problems / stack_auxes /
# solve_portfolio_batched, the primitives above vmapped over a leading
# region axis) lives in core.federation, its only consumer; lazy aliases
# keep ``solvers.solve_portfolio_batched`` imports working, as in the JAX
# package.
_FEDERATION_MOVED = ("solve_portfolio_batched", "stack_problems",
                     "stack_auxes", "_pad_links", "_solve_regions",
                     "_solve_regions_loop", "_BATCH_EFFORT")


def __getattr__(name: str):
    if name in _FEDERATION_MOVED:
        from . import federation
        return getattr(federation, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def repair_to_eligible(problem: PlacementProblem, res: SolveResult,
                       eligible: np.ndarray) -> SolveResult:
    """Force a solved placement onto an [R, P] eligibility mask: each free
    VM outside its row's eligible set moves to its masked ``delta_sweep``
    argmin (live state kept consistent so later repairs see earlier ones).
    The input result is returned as it is when nothing violates."""
    el_np, _, _ = _eligible_np(eligible)
    X = np.asarray(res.X).copy()
    fixed = problem.fixed_mask.cpu().numpy()
    rows = np.arange(X.shape[0])[:, None]
    if not np.any(~el_np[rows, X] & ~fixed):
        return res
    aux = build_aux(problem)
    state = init_state(problem, X)
    for r in range(X.shape[0]):
        mask_r = torch.as_tensor(el_np[r], device=problem.device)
        for v in range(X.shape[1]):
            if fixed[r, v] or el_np[r, X[r, v]]:
                continue
            obj_all = delta_sweep(problem, aux, state, r, v)
            best = int(torch.argmin(torch.where(
                mask_r, obj_all, torch.full_like(obj_all, float("inf")))))
            state = apply_move(problem, aux, state, r, v, best)
            X[r, v] = best
    return _result(problem, X, res.method, res.history)


# ---------------------------------------------------------------------------
# Online incremental re-embedding (service churn)
# ---------------------------------------------------------------------------

def _pad_positions(pos: np.ndarray, m: Optional[int]) -> np.ndarray:
    """Pad a free-position list to a fixed length by repeating the first row
    (shape bucketing, as in the JAX package: a repeated sweep position is a
    re-sweep of that VM)."""
    if m is None or pos.shape[0] == 0 or pos.shape[0] >= m:
        return pos
    return np.concatenate(
        [pos, np.tile(pos[:1], (m - pos.shape[0], 1))])


def _incremental_streams(gen: torch.Generator, n_steps: int, n_chains: int,
                         problem: PlacementProblem, target_rows: np.ndarray,
                         cnt: Optional[np.ndarray] = None,
                         cand: Optional[np.ndarray] = None):
    """The re-solve's Metropolis draws ``(fi, p_prop, u_prop, rand)``:
    index into the target positions (whose rows are ``target_rows``)
    [T, C], destination node [T, C], uniform [T, C] and the restart
    placements [C, R, V], drawn from ``gen`` in that order.  With an
    eligibility table destinations and restarts come from each row's
    eligible set."""
    P, R, V = problem.P, problem.R, problem.V
    fi = torch.randint(0, len(target_rows), (n_steps, n_chains),
                       generator=gen)
    if cnt is None:
        p_prop = torch.randint(0, P, (n_steps, n_chains), generator=gen,
                               dtype=torch.int32)
    else:
        cnt_t, cand_t = torch.as_tensor(cnt), torch.as_tensor(cand)
        u_dst = torch.rand((n_steps, n_chains), generator=gen)
        p_prop = _sample_eligible(
            u_dst, torch.as_tensor(target_rows)[fi], cnt_t, cand_t)
    u_prop = torch.rand((n_steps, n_chains), generator=gen)
    if cnt is None:
        rand = torch.randint(0, P, (n_chains, R, V), generator=gen,
                             dtype=torch.int32)
    else:
        u_r = torch.rand((n_chains, R, V), generator=gen)
        rand = _sample_eligible(u_r, torch.arange(R)[None, :, None], cnt_t,
                                cand_t)
    return fi, p_prop, u_prop, rand


def resolve_incremental(problem: PlacementProblem, prev_X=None,
                        gen: Optional[torch.Generator] = None,
                        changed_rows: Optional[Sequence[int]] = None,
                        state: Optional[PlacementState] = None,
                        sweeps: Optional[int] = None,
                        anneal_steps: Optional[int] = None,
                        anneal_chains: Optional[int] = None,
                        anneal_t0: Optional[float] = None,
                        anneal_t1: Optional[float] = None,
                        polish_sweeps: Optional[int] = None,
                        eligible: Optional[np.ndarray] = None,
                        pad_positions_to: Optional[int] = None,
                        pad_changed_to: Optional[int] = None,
                        spec=None, record_conv: bool = False,
                        streams: Optional[tuple] = None) -> SolveResult:
    """Warm-start re-solve after service churn: surviving services stay at
    their previous nodes, only the VMs of ``changed_rows`` (new arrivals /
    rows the caller distrusts) are actively re-placed.

    Three phases, all on the delta engine:
      1. targeted coordinate sweeps over the changed rows' free VMs
         (survivors act as implicit pins -- their positions are never swept);
      2. a short Metropolis refinement (``_anneal_scan_delta``): with
         changed rows, proposals touch ONLY those VMs; without them (a
         departure), proposals range over ALL free VMs.  Chain 0 stays
         warm, the others restart at the target positions;
      3. ``polish_sweeps`` full sweeps over ALL free VMs (monotone).
    The warm start and the placements of phases 1 and 2 are re-scored
    exactly in one ``kernels.ops.placement_objective`` call (the
    placement_power kernel on a CUDA problem) and the best is polished.

    ``spec`` (an ``api.PlacementSpec``, optional) supplies the solver knobs
    and -- unless ``eligible`` is passed -- the constraint masks via
    ``spec.masks(problem)``; explicit keyword arguments override the spec.
    ``eligible`` [R, P] restricts each row's destinations through every
    phase (a mask-violating warm start is projected onto it first).
    ``pad_positions_to`` / ``pad_changed_to`` pad the full and the changed
    position lists (the JAX package's shape buckets; the results are that
    package's).  Random draws come from ``gen`` (a CPU generator, seed 0
    when None); ``streams`` injects ``(fi, p_prop, u_prop, rand)`` instead
    (``_incremental_streams``' layout; the tests pass the JAX package's
    draws).  Pass the caller's carried ``state`` (``power.warm_state``) and
    no ``prev_X``: ``prev_X`` is read only when ``state`` is absent.
    """
    from ..kernels import ops as kops
    pick = lambda v, sv, d: (v if v is not None
                             else (sv if sv is not None else d))
    sweeps = pick(sweeps, getattr(spec, "sweeps", None), 2)
    anneal_steps = pick(anneal_steps, getattr(spec, "anneal_steps", None), 600)
    anneal_chains = pick(anneal_chains,
                         getattr(spec, "anneal_chains", None), 8)
    anneal_t0 = pick(anneal_t0, getattr(spec, "anneal_t0", None), 5.0)
    anneal_t1 = pick(anneal_t1, getattr(spec, "anneal_t1", None), 0.05)
    polish_sweeps = pick(polish_sweeps,
                         getattr(spec, "polish_sweeps", None), 2)
    if eligible is None and spec is not None:
        eligible = spec.masks(problem)
    dev = problem.device
    aux = build_aux(problem)
    if state is None:
        if prev_X is None:
            raise ValueError("resolve_incremental needs prev_X or state")
        state = init_state(problem, prev_X)
    # else: the caller-carried state is trusted as-is -- candidates are
    # re-scored exactly below, so carried float32 drift cannot corrupt it
    changed_rows = [] if changed_rows is None else list(changed_rows)
    free = aux.free_pos.cpu().numpy()
    if free.shape[0] == 0:  # everything pinned: nothing to re-place
        return _result(problem, state.X, "incremental")
    el_np, cnt_np, cand_np = _eligible_np(eligible)
    el_t = None if el_np is None else torch.as_tensor(el_np, device=dev)
    if el_np is not None:
        # the warm incumbent may predate the mask: project it first, so a
        # mask-violating placement can never win the argmin below
        X0, moved = _project_eligible(problem, state.X, el_np)
        if moved:
            state = init_state(problem, apply_pins(problem, X0))
    cands = [state.X]
    pos_changed = _pad_positions(free[np.isin(free[:, 0], changed_rows)],
                                 pad_changed_to)

    # phase 1: greedy placement of the changed VMs
    if pos_changed.shape[0]:
        for _ in range(max(1, sweeps)):
            state, _ = _sweep(problem, aux, state, pos_changed, el_t)
        cands.append(state.X)

    # phase 2: short Metropolis refinement
    conv: Optional[Dict[str, np.ndarray]] = None
    if anneal_steps > 0 and anneal_chains > 0:
        R, V = problem.R, problem.V
        target = pos_changed if pos_changed.shape[0] else free
        flat = torch.as_tensor(target[:, 0] * V + target[:, 1])
        if streams is None:
            gen = default_generator() if gen is None else gen
            streams = _incremental_streams(
                gen, anneal_steps, anneal_chains, problem, target[:, 0],
                cnt=cnt_np, cand=cand_np)
        fi, p_prop, u_prop, rand = (torch.as_tensor(np.array(s))
                                    for s in streams)
        j_prop = flat[fi.long()]
        temps = _temps(anneal_steps, anneal_t0, anneal_t1, dev)
        Xc = state.X.expand(anneal_chains, R, V)
        # chain 0 stays warm; the rest restart at the target positions only
        tgt = np.zeros((R, V), dtype=bool)
        tgt[target[:, 0], target[:, 1]] = True
        keep = ((torch.arange(anneal_chains, device=dev) == 0)[:, None, None]
                | ~torch.as_tensor(tgt, device=dev)[None])
        Xc = torch.where(keep, Xc, rand.to(dev, torch.int32))
        bX, _, hist = _anneal_scan_delta(problem, aux, Xc, j_prop, p_prop,
                                         u_prop, temps)
        cands.append(bX)
        if record_conv:
            conv = {"best_obj": hist[0].cpu().numpy(),
                    "accept_rate": hist[1].cpu().numpy()}

    # pick the exact-objective best (one batched re-score), then polish
    objs = kops.placement_objective(problem, torch.stack(cands))[:, 0]
    objs = [float(o) for o in objs.cpu()]
    k = int(np.argmin(objs))
    best_obj, best_X = objs[k], cands[k]
    history: List[float] = objs + [best_obj]
    if polish_sweeps > 0:
        state = init_state(problem, best_X)
        pa = _pad_positions(free, pad_positions_to)
        for _ in range(polish_sweeps):
            state, _ = _sweep(problem, aux, state, pa, el_t)
        obj = float(objective(problem, state.X))
        if obj < best_obj:
            best_obj, best_X = obj, state.X
        history.append(best_obj)
    res = _result(problem, best_X, "incremental", history)
    res.conv = conv
    return res


def resolve_wave(problem: PlacementProblem,
                 state: PlacementState,
                 changed_rows: Sequence[int],
                 gen: Optional[torch.Generator] = None,
                 pad_changed_to: Optional[int] = None,
                 spec=None, **kw) -> SolveResult:
    """Wave-batched incremental re-solve: ONE warm-start pass over a whole
    churn wave instead of one per event.

    The caller detaches a tick's departures and concatenates its arrivals
    as one state update and builds ONE ``power.warm_state``
    (``changed_rows`` = the arrival rows; departures need none).  This runs
    ``resolve_incremental``'s three phases once for the wave: targeted
    sweeps over every changed row's free VMs, one Metropolis refinement
    over the union of changed positions, and one polish pass -- the polish
    that dominates an event's time is paid once per wave.  The changed
    position list is padded to a power-of-two bucket (``pad_changed_to``,
    default ``_pow2`` of the wave's free positions), as in the JAX package.
    ``kw`` (``streams=`` among them) passes through to
    ``resolve_incremental``."""
    changed_rows = list(changed_rows)
    if pad_changed_to is None and changed_rows:
        n_pos = int((~problem.host.fixed_mask[changed_rows]).sum())
        if n_pos:
            pad_changed_to = _pow2(n_pos)
    res = resolve_incremental(problem, gen=gen, changed_rows=changed_rows,
                              state=state, spec=spec,
                              pad_changed_to=pad_changed_to, **kw)
    return SolveResult(X=res.X, breakdown=res.breakdown, method="wave",
                       history=res.history, conv=res.conv)
