"""The CFN power model: paper Eq. (1) + Eq. (2), full and incremental (torch).

Given a placement ``X[r, v]`` (processing-node index per VM), total power is

  net_pc = sum_n PUE_n * ( eps_n * lambda_n + beta_n * delta_n * pi_n )      (1)
  pr_pc  = sum_p PUE_p * ( E_p * Omega_p + N_p * pi_p
                           + EL_p * theta_p + Phi_p * share_p * pi_p^LAN )   (2)

with lambda_n accumulated along the padded-CSR route table of topology.py:
``route_idx[b, e, :]`` lists the <= K network nodes of the (b, e) route
(sentinel N marks padding).

Two regimes, as in the JAX package:

  * **Full evaluation** (``evaluate`` / ``objective_batch``): loads from
    scatter-adds over the VMs and virtual links of each candidate, batched
    over a leading candidate dimension.
  * **Delta evaluation** (the state engine): a solver proposal moves ONE VM,
    so ``_move_core`` / ``_delta_objective`` re-score only the touched
    entries -- the processing terms at the source and destination node, the
    network terms along the touched routes.  ``delta_sweep`` scores all P
    destinations of one VM at once (coordinate descent).  Float32 residue of
    exact +/- cancellation is snapped to zero (SNAP_*) so the beta/phi
    activation indicators stay exact.

Every tensor of a ``PlacementProblem`` lives on one device; entry points take
``device=None``, which means CUDA and raises when there is none.  Node and
link indices are int32 at the public boundary (``X``, ``route_idx``,
``link_src``/``link_dst``) and int64 inside, where torch indexing wants it.

Units: W, GFLOPS, Mbps (converted to Gbps where eps/EL are W per Gbps).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass, fields
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as _pytree

from .topology import CFNTopology
from .vsr import VSRBatch

# Penalty weight for capacity violations (W per unit violation); large enough
# that any feasible placement beats any infeasible one at paper scale.
PENALTY = 1.0e4
# lambda_n > ACTIVE_EPS Mbps counts a network node as activated.
ACTIVE_EPS = 1.0e-6
# Incremental-state snapping: after a +/- float32 update, magnitudes below
# these are residue of exact cancellation, not real load (smallest true
# demands are ~0.1 GFLOPS / ~5 Mbps).  Mirrored in csrc/fused_anneal.cu and
# kernels/placement_power.py.
SNAP_GFLOPS = 1.0e-3
SNAP_MBPS = 1.0e-2
# Substrates up to this many processing nodes additionally carry the dense
# [P*P, N] route incidence table (``PlacementProblem.route_dense``); above the
# gate the O(P^2*N) operand is exactly what the CSR table avoids.
DENSE_ROUTE_MAX_P = 64

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` means the CUDA card; raise when it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


class HostArrays(NamedTuple):
    """Numpy copies of the problem tensors the per-service state operations
    read on the host (``service_loads``, ``warm_state``)."""
    route_idx: np.ndarray     # [P, P, K] int32
    F: np.ndarray             # [R, V]
    link_src: np.ndarray      # [L] int32
    link_dst: np.ndarray      # [L] int32
    link_h: np.ndarray        # [L]
    fixed_mask: np.ndarray    # [R, V] bool
    fixed_node: np.ndarray    # [R, V] int32


class PowerBreakdown(NamedTuple):
    total: torch.Tensor       # [] W (net + pr, no penalty)
    net: torch.Tensor         # [] W
    proc: torch.Tensor        # [] W
    violation: torch.Tensor   # [] capacity violation magnitude (0 = feasible)
    per_proc: torch.Tensor    # [P] W
    per_net: torch.Tensor     # [N] W
    omega: torch.Tensor       # [P] GFLOPS allocated

    @property
    def objective(self):
        return self.total + PENALTY * self.violation


@dataclass(frozen=True, eq=False)
class PlacementProblem:
    """Immutable tensor bundle: substrate parameters + workload, on one
    device.  Field names and layouts are the JAX package's."""

    # substrate ----------------------------------------------------------
    route_idx: torch.Tensor   # [P, P, K] int32 network-node ids, pad = N
    E: torch.Tensor           # [P] W/GFLOPS
    C_pr: torch.Tensor        # [P] GFLOPS per server
    NS: torch.Tensor          # [P] servers
    pi_pr: torch.Tensor       # [P] W idle per server
    pue_pr: torch.Tensor      # [P]
    EL: torch.Tensor          # [P] W/Gbps (LAN)
    C_lan: torch.Tensor       # [P] Gbps
    pi_lan: torch.Tensor      # [P] W
    lan_share: torch.Tensor   # [P]
    eps: torch.Tensor         # [N] W/Gbps
    C_net: torch.Tensor       # [N] Gbps
    pi_net: torch.Tensor      # [N] W
    pue_net: torch.Tensor     # [N]
    idle_share: torch.Tensor  # [N]
    # workload -----------------------------------------------------------
    F: torch.Tensor           # [R, V] GFLOPS
    link_src: torch.Tensor    # [L] int32 (flattened r*V+v)
    link_dst: torch.Tensor    # [L] int32
    link_h: torch.Tensor      # [L] Mbps
    fixed_mask: torch.Tensor  # [R, V] bool: True where VM is pinned
    fixed_node: torch.Tensor  # [R, V] int32: pinned node (src for input VMs)
    # optional dense route-row cache (small substrates only; see
    # DENSE_ROUTE_MAX_P): [P*P, N] float32 incidence rows, None above it
    route_dense: Optional[torch.Tensor] = None

    @property
    def P(self) -> int:
        return self.E.shape[0]

    @property
    def N(self) -> int:
        return self.eps.shape[0]

    @property
    def K(self) -> int:
        return self.route_idx.shape[2]

    @property
    def R(self) -> int:
        return self.F.shape[0]

    @property
    def V(self) -> int:
        return self.F.shape[1]

    @property
    def device(self) -> torch.device:
        return self.E.device

    # int64 / packed views, computed once per problem --------------------
    @functools.cached_property
    def route_long(self) -> torch.Tensor:        # [P, P, K] int64
        return self.route_idx.long()

    @functools.cached_property
    def route_flat(self) -> torch.Tensor:        # [P*P, K] int64
        return self.route_long.reshape(self.P * self.P, self.K)

    @functools.cached_property
    def route_counts(self) -> torch.Tensor:      # [P*P, N+1] float32
        """Visits of route (a, b) to each network node (column N: the
        sentinel), for ``_lam_from_tm`` on CUDA.  Sums of ones are exact
        in any order, so the atomic scatter builds them reproducibly."""
        counts = torch.zeros(self.P * self.P, self.N + 1,
                             device=self.device)
        return counts.scatter_add_(1, self.route_flat,
                                   torch.ones_like(self.route_flat,
                                                   dtype=counts.dtype))

    @functools.cached_property
    def ls(self) -> torch.Tensor:                # [L] int64
        return self.link_src.long()

    @functools.cached_property
    def ld(self) -> torch.Tensor:                # [L] int64
        return self.link_dst.long()

    @functools.cached_property
    def F_flat(self) -> torch.Tensor:            # [R*V]
        return self.F.reshape(-1)

    @functools.cached_property
    def proc_pack(self) -> torch.Tensor:
        """[8, P]: E, C_pr, pi_pr, pue_pr, EL, share*pi_lan, NS*C_pr, C_lan
        -- the per-node operands the delta objective gathers at once."""
        return torch.stack([self.E, self.C_pr, self.pi_pr, self.pue_pr,
                            self.EL, self.lan_share * self.pi_lan,
                            self.NS * self.C_pr, self.C_lan])

    @functools.cached_property
    def host(self) -> HostArrays:
        """Host copies for the per-service state operations.  ``build_problem``
        seeds them with the arrays it built the tensors from (the route
        table is the topology's own), so nothing is copied back from the
        device; a problem made another way copies each tensor once."""
        n = lambda t: t.cpu().numpy()
        return HostArrays(route_idx=n(self.route_idx), F=n(self.F),
                          link_src=n(self.link_src), link_dst=n(self.link_dst),
                          link_h=n(self.link_h), fixed_mask=n(self.fixed_mask),
                          fixed_node=n(self.fixed_node))


# A problem is a pytree of its field tensors (``route_dense`` only when
# present) plus the int64 / packed views already computed, so
# ``torch.func.vmap`` over a stacked problem (leading region axis,
# ``core/federation.py``) sees each region's problem with its views
# precomputed instead of rebuilding them on every call.
_VIEWS = ("route_long", "route_flat", "ls", "ld", "F_flat", "proc_pack")


def _problem_flatten(p: PlacementProblem):
    names = tuple(f.name for f in fields(PlacementProblem)
                  if getattr(p, f.name) is not None)
    views = tuple(k for k in _VIEWS if k in p.__dict__)
    return ([getattr(p, n) for n in names]
            + [p.__dict__[k] for k in views], (names, views))


def _problem_unflatten(children, context) -> PlacementProblem:
    names, views = context
    p = PlacementProblem(**dict(zip(names, children[:len(names)])))
    p.__dict__.update(zip(views, children[len(names):]))
    return p


_pytree.register_pytree_node(PlacementProblem, _problem_flatten,
                             _problem_unflatten)


def problem_from_numpy(arrays: Dict[str, Optional[np.ndarray]],
                       device: Device = None) -> PlacementProblem:
    """A ``PlacementProblem`` from numpy arrays keyed by its field names
    (the JAX package's ``PlacementProblem`` fields; ``route_dense`` may be
    missing or ``None``).  Dtypes are kept as given."""
    dev = resolve_device(device)
    kw = {}
    for f in fields(PlacementProblem):
        v = arrays.get(f.name)
        kw[f.name] = (None if v is None
                      else to_tensor(v, dev))
    return PlacementProblem(**kw)


def substrate_arrays(topo: CFNTopology,
                     device: Device = None) -> Dict[str, torch.Tensor]:
    """Workload-independent problem tensors on ``device``.  Cache and pass to
    ``build_problem`` when building many problems on one topology."""
    dev = resolve_device(device)
    host = {**topo.proc_param_arrays(), **topo.net_param_arrays(),
            "route_idx": topo.route_idx}
    out = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    out["route_dense"] = (
        torch.as_tensor(topo.dense_path_nodes().reshape(topo.P * topo.P,
                                                        topo.N), device=dev)
        if topo.P <= DENSE_ROUTE_MAX_P else None)
    return out


def build_problem(topo: CFNTopology, vsrs: VSRBatch,
                  substrate: Optional[Dict[str, torch.Tensor]] = None,
                  pad_to_rows: Optional[int] = None,
                  pad_to_cols: Optional[int] = None,
                  device: Device = None) -> PlacementProblem:
    """Build the tensor bundle for one workload on one substrate.

    ``pad_to_rows`` pads the service dimension with zero-demand, link-free
    dummy services whose every VM is PINNED to node 0; ``pad_to_cols``
    widens every service with zero-demand, link-free VMs pinned to the
    row's source node.  Neither changes the objective or the solver move
    set (shape bucketing, as in the JAX package).  With ``substrate`` given
    the problem lives on the substrate's device.
    """
    if substrate is None:
        substrate = substrate_arrays(topo, device)
    dev = substrate["route_idx"].device
    V_nat = vsrs.V
    if pad_to_cols is not None and pad_to_cols > V_nat:
        vsrs = vsrs.widen(pad_to_cols)
    link_src, link_dst, link_h = vsrs.links()
    R, V = vsrs.R, vsrs.V
    fixed_mask = np.zeros((R, V), dtype=bool)
    fixed_mask[np.arange(R), vsrs.input_vm] = True
    fixed_node = np.zeros((R, V), dtype=np.int32)
    fixed_node[np.arange(R), vsrs.input_vm] = vsrs.src
    if V > V_nat:
        fixed_mask[:, V_nat:] = True
        fixed_node[:, V_nat:] = np.asarray(vsrs.src)[:, None]
    F = np.asarray(vsrs.F)
    if pad_to_rows is not None and pad_to_rows > R:
        pad = pad_to_rows - R
        F = np.concatenate([F, np.zeros((pad, V), F.dtype)])
        fixed_mask = np.concatenate([fixed_mask, np.ones((pad, V), bool)])
        fixed_node = np.concatenate(
            [fixed_node, np.zeros((pad, V), np.int32)])
    t = lambda x: torch.as_tensor(x, device=dev)
    problem = PlacementProblem(
        **substrate, F=t(F), link_src=t(link_src), link_dst=t(link_dst),
        link_h=t(link_h), fixed_mask=t(fixed_mask), fixed_node=t(fixed_node))
    # seed the cached ``host`` property (what cached_property itself does)
    problem.__dict__["host"] = HostArrays(
        route_idx=topo.route_idx, F=F, link_src=np.asarray(link_src),
        link_dst=np.asarray(link_dst), link_h=np.asarray(link_h),
        fixed_mask=fixed_mask, fixed_node=fixed_node)
    return problem


def to_tensor(x, device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """``x`` (numpy, list or tensor) as a tensor on ``device``."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()    # torch does not wrap read-only numpy memory
    t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)


def as_placement(problem: PlacementProblem, X) -> torch.Tensor:
    """``X`` (numpy, list or tensor) as an int32 tensor on the problem's
    device."""
    return to_tensor(X, problem.device, torch.int32)


def apply_pins(problem: PlacementProblem, X: torch.Tensor) -> torch.Tensor:
    """Force pinned VMs (input VMs) onto their source nodes; X [..., R, V]."""
    return torch.where(problem.fixed_mask, problem.fixed_node,
                       as_placement(problem, X))


# ---------------------------------------------------------------------------
# Substrate health: failures degrade capacities by value (no shape changes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SubstrateHealth:
    """Up/down state of the physical substrate.

    ``node_up`` [P] marks processing nodes, ``link_up`` [N] network
    elements.  Failures never change tensor shapes: ``degrade`` returns a
    same-shape ``PlacementProblem`` whose failed elements have zero
    capacity (NS = 0 servers, C_lan = 0, C_net = 0), so any load left on a
    dead element draws the capacity penalty, while a drained dead element
    draws zero watts because every idle term is activity gated.  ``C_pr``,
    idle powers and routes are untouched.

    ``eligibility`` is the planning-side view: an [R, P] mask that removes
    dead nodes -- and every node whose route from the row's source crosses
    a dead network element -- from the solver move set
    (``PlacementSpec.masks`` ANDs it with the hop / affinity masks).

    Instances are immutable; the ``fail_*`` / ``recover_*`` methods return
    updated copies.
    """

    node_up: np.ndarray   # [P] bool
    link_up: np.ndarray   # [N] bool

    @classmethod
    def fresh(cls, topo: CFNTopology) -> "SubstrateHealth":
        return cls(node_up=np.ones(topo.P, dtype=bool),
                   link_up=np.ones(topo.N, dtype=bool))

    @property
    def all_up(self) -> bool:
        return bool(self.node_up.all()) and bool(self.link_up.all())

    def _set(self, field: str, idx: int, up: bool) -> "SubstrateHealth":
        arr = np.array(getattr(self, field), dtype=bool)
        arr[int(idx)] = up
        return dataclasses.replace(self, **{field: arr})

    def fail_node(self, p: int) -> "SubstrateHealth":
        return self._set("node_up", p, False)

    def recover_node(self, p: int) -> "SubstrateHealth":
        return self._set("node_up", p, True)

    def fail_link(self, n: int) -> "SubstrateHealth":
        return self._set("link_up", n, False)

    def recover_link(self, n: int) -> "SubstrateHealth":
        return self._set("link_up", n, True)

    def degrade(self, problem: PlacementProblem) -> PlacementProblem:
        """Same-shape problem with dead elements' capacities zeroed: new
        tensors on the problem's device, never a write into ``problem``
        (whose substrate tensors the online engine shares across events).
        The host copies carry over (none of them is a capacity), so no
        state operation copies the route table back from the device; the
        problem itself comes back when everything is up."""
        if self.all_up:
            return problem
        nu = torch.as_tensor(self.node_up, device=problem.device)
        lu = torch.as_tensor(self.link_up, device=problem.device)
        out = dataclasses.replace(problem,
                                  NS=torch.where(nu, problem.NS, 0.0),
                                  C_lan=torch.where(nu, problem.C_lan, 0.0),
                                  C_net=torch.where(lu, problem.C_net, 0.0))
        if "host" in problem.__dict__:
            out.__dict__["host"] = problem.host
        return out

    def route_ok(self) -> np.ndarray:
        """[N+1] link aliveness lookup with the sentinel slot alive, for
        indexing ``route_idx`` (pad entries hold id N)."""
        return np.concatenate([np.asarray(self.link_up, bool), [True]])

    def pair_alive(self, problem: PlacementProblem) -> np.ndarray:
        """[P, P] bool: route (a, b) traverses no dead network element."""
        return self.route_ok()[problem.host.route_idx].all(axis=-1)

    def eligibility(self, problem: PlacementProblem) -> np.ndarray:
        """[R, P] bool solver mask under the current health.

        A node is eligible for row r iff it is up AND the route from r's
        pinned source traverses only live network elements.  Rows whose
        source node is itself dead keep their route mask (the engine
        strands them before any solve); rows left with an empty mask must
        likewise be stranded by the caller -- the solvers' all-True
        fallback would otherwise quietly re-enable dead nodes."""
        if self.all_up:
            return np.ones((problem.R, problem.P), dtype=bool)
        h = problem.host
        src_of = h.fixed_node[np.arange(problem.R),
                              h.fixed_mask.argmax(axis=1)]          # [R]
        el = self.pair_alive(problem)[src_of]                        # [R, P]
        return el & np.asarray(self.node_up, bool)[None, :]


# ---------------------------------------------------------------------------
# Full evaluation
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def fixed_order(x: torch.Tensor):
    """A context under which scatter and index sums into ``x`` add in a
    fixed order.  On CUDA, ``scatter_add_`` and ``index_add_`` add with
    atomics in no fixed order, so float32 loads of one placement could
    differ in their last bit from call to call, and a sweep's argmin tie
    break the other way; torch's deterministic algorithms sum them in a
    fixed order (a stable sort by index) instead.  The CPU's sums are
    sequential already."""
    if x.is_cuda and not torch.are_deterministic_algorithms_enabled():
        return _deterministic()
    return contextlib.nullcontext()


# On CUDA a sum of at most this many (index, slot) pairs is one reduction
# over its one-hot product (a few kernels and <= 64 MB, against the sort
# of ``fixed_order``'s path: the delta engine's per-move sums of <= 2 D K
# terms, a placement's loads, a few dozen chains' at R = 64); a larger
# one sorts.
ONEHOT_MAX = 1 << 24


def _onehot_rows(n: int, idx: torch.Tensor, val: torch.Tensor):
    """``_scatter_rows`` as one reduction over the one-hot product
    [..., m, n]: its summation order is the reduction's, fixed."""
    hit = idx[..., None] == torch.arange(n, device=idx.device)
    return (val[..., None] * hit).sum(-2)


def _scatter_rows(n: int, idx: torch.Tensor, val: torch.Tensor):
    """[..., n] sums of ``val`` at ``idx`` along the last axis (``idx`` and
    ``val`` share their shape [..., m]), in a fixed order: sequential on
    the CPU; on CUDA a reduction over the one-hot product up to
    ``ONEHOT_MAX`` pairs, else a scatter under ``fixed_order``.  The
    accumulator is made from ``val``, so the sum also runs under
    ``torch.func.vmap`` (the region-batched solve of
    ``core/federation.py``)."""
    if val.is_cuda and idx.numel() * n <= ONEHOT_MAX:
        return _onehot_rows(n, idx, val)
    out = val.new_zeros(idx.shape[:-1] + (n,))
    with fixed_order(out):
        return out.scatter_add_(-1, idx, val)


def _lam_from_links(problem: PlacementProblem,
                    X_flat: torch.Tensor) -> torch.Tensor:
    """lambda [..., N] for HARD placements X_flat [..., J]: each virtual
    link's bitrate accumulated along its route's <= K node ids.  Small
    substrates gather the dense ``route_dense`` incidence rows instead (same
    values)."""
    p = problem
    Xl = X_flat.long()
    a, b = Xl[..., p.ls], Xl[..., p.ld]                            # [..., L]
    if p.route_dense is not None:
        return torch.einsum("l,...ln->...n", p.link_h,
                            p.route_dense[a * p.P + b])
    ids = p.route_flat[a * p.P + b]                                # [..., L, K]
    h = p.link_h[:, None].expand(ids.shape)
    lam = _scatter_rows(p.N + 1, ids.flatten(-2), h.flatten(-2))
    return lam[..., :p.N]


def _loads(problem: PlacementProblem, X_flat: torch.Tensor,
           with_tm: bool = False):
    """Loads of hard placements X_flat [..., J] (pins applied):
    ``(omega [..., P], tm [P, P] or None, lam [..., N], theta [..., P])``.
    ``tm`` (the inter-node traffic matrix) is built for a single placement
    only, when ``with_tm``."""
    p = problem
    Xl = X_flat.long()
    omega = _scatter_rows(p.P, Xl, p.F_flat.expand(Xl.shape))
    a, b = Xl[..., p.ls], Xl[..., p.ld]                            # [..., L]
    h = p.link_h.expand(a.shape)
    # traffic touching node p: out + in, intra-node links counted once
    theta = _scatter_rows(p.P, torch.cat([a, b], -1),
                          torch.cat([h, h * (a != b)], -1))
    lam = _lam_from_links(p, X_flat)
    tm = None
    if with_tm:
        tm = h.new_zeros(p.P * p.P)
        with fixed_order(tm):
            tm = tm.index_add_(0, a * p.P + b, h).reshape(p.P, p.P)
    return omega, tm, lam, theta


def _lam_from_tm(problem: PlacementProblem,
                 tm: torch.Tensor) -> torch.Tensor:
    """lambda [..., N] from traffic matrices tm [..., P, P]: each (a, b)
    entry added at the <= K node ids of route (a, b) (sentinel ids land in
    the dropped N-th slot).  Takes soft (fractional) traffic and is
    differentiable.  On CUDA the P^2 K terms are one float32 product with
    ``route_counts``, whose sums run in a fixed order (sorting them every
    call, as ``fixed_order`` would, made ``relax`` ~30x slower); a caller
    that enables TF32 matmuls rounds its operands."""
    p = problem
    lead = tm.shape[:-2]
    if tm.is_cuda:
        return (tm.reshape(*lead, p.P * p.P) @ p.route_counts)[..., :p.N]
    w = tm[..., None].expand(*lead, p.P, p.P, p.K)
    lam = torch.zeros(*lead, p.N + 1, dtype=tm.dtype, device=tm.device)
    lam.index_add_(-1, p.route_flat.reshape(-1), w.reshape(*lead, -1))
    return lam[..., :p.N]


def _soft_loads(problem: PlacementProblem, onehot: torch.Tensor):
    """Loads of (soft) assignments onehot [..., R, V, P], pins applied:
    ``(omega [..., P], tm [..., P, P], lam [..., N], theta [..., P])``."""
    p = problem
    omega = torch.einsum("...rvp,rv->...p", onehot, p.F)
    flat = onehot.flatten(-3, -2)                                # [..., J, P]
    u = flat[..., p.ls, :]                                       # [..., L, P]
    w = flat[..., p.ld, :]
    tm = torch.einsum("l,...lp,...lq->...pq", p.link_h, u, w)
    intra = torch.einsum("l,...lp,...lp->...p", p.link_h, u, w)
    lam = _lam_from_tm(p, tm)                                    # Mbps
    theta = (torch.einsum("...lp,l->...p", u, p.link_h)
             + torch.einsum("...lp,l->...p", w, p.link_h) - intra)
    return omega, tm, lam, theta


def _assemble_terms(p: PlacementProblem, omega, lam, theta, n_srv, beta,
                    phi):
    """Eq.(1)/(2) term assembly shared by the hard and soft branches:
    (per_net [..., N], per_proc [..., P], violation [...])."""
    per_net = p.pue_net * (p.eps * lam / 1e3 + beta * p.idle_share * p.pi_net)
    per_proc = p.pue_pr * (p.E * omega + n_srv * p.pi_pr
                           + p.EL * theta / 1e3
                           + phi * p.lan_share * p.pi_lan)
    relu = torch.relu
    violation = (relu(omega - p.NS * p.C_pr).sum(-1)
                 + relu(lam / 1e3 - p.C_net).sum(-1)
                 + relu(theta / 1e3 - p.C_lan).sum(-1))
    return per_net, per_proc, violation


def _hard_terms(problem: PlacementProblem, omega, lam, theta):
    """Eq.(1)/(2) terms for hard placements; broadcasts over leading dims.

    omega/theta [..., P], lam [..., N] -> (per_net [..., N], per_proc
    [..., P], violation [...]).
    """
    p = problem
    n_srv = torch.ceil(omega / p.C_pr)
    beta = (lam > ACTIVE_EPS).float()
    phi = ((omega > ACTIVE_EPS) | (theta > ACTIVE_EPS)).float()
    return _assemble_terms(p, omega, lam, theta, n_srv, beta, phi)


def evaluate_batch(problem: PlacementProblem, Xb, hard: bool = True,
                   temp: float = 1.0) -> PowerBreakdown:
    """Power breakdown of placements Xb [..., R, V] (int node indices);
    every field carries the leading dims.

    ``hard=False`` computes the differentiable surrogate of the relaxation
    solver: Xb is then [..., R, V, P] soft assignment probabilities (pins
    forced one-hot on their nodes), ceil() becomes a smooth overcount
    (omega / C + sigmoid(omega / temp)) and each activation indicator a
    saturating gate (1 - exp(-load / temp)).
    """
    p = problem
    if hard:
        X = apply_pins(p, Xb)
        omega, _, lam, theta = _loads(p, X.flatten(-2))
        per_net, per_proc, violation = _hard_terms(p, omega, lam, theta)
    else:
        soft = to_tensor(Xb, p.device, torch.float32)
        pin_oh = torch.nn.functional.one_hot(p.fixed_node.long(),
                                             p.P).to(soft.dtype)
        onehot = torch.where(p.fixed_mask[..., None], pin_oh, soft)
        omega, _, lam, theta = _soft_loads(p, onehot)
        n_srv = omega / p.C_pr + torch.sigmoid(omega / temp)
        beta = 1.0 - torch.exp(-lam / temp)
        phi = 1.0 - torch.exp(-(omega + theta) / temp)
        per_net, per_proc, violation = _assemble_terms(
            p, omega, lam, theta, n_srv, beta, phi)
    net, proc = per_net.sum(-1), per_proc.sum(-1)
    return PowerBreakdown(total=net + proc, net=net, proc=proc,
                          violation=violation, per_proc=per_proc,
                          per_net=per_net, omega=omega)


def evaluate(problem: PlacementProblem, X, hard: bool = True,
             temp: float = 1.0) -> PowerBreakdown:
    """Total power for one placement X [R, V] (int node indices), or with
    ``hard=False`` the soft surrogate of assignments X [R, V, P]
    (``evaluate_batch``)."""
    return evaluate_batch(problem, X, hard=hard, temp=temp)


def objective(problem: PlacementProblem, X) -> torch.Tensor:
    """Scalar objective (power + capacity penalty) for a hard placement."""
    return evaluate(problem, X).objective


def objective_batch(problem: PlacementProblem, Xb) -> torch.Tensor:
    """Objectives [B] of placements Xb [B, R, V]."""
    return evaluate_batch(problem, Xb).objective


# ---------------------------------------------------------------------------
# Incremental delta evaluation
# ---------------------------------------------------------------------------

class PlacementAux(NamedTuple):
    """Static per-problem precomputation for the delta engine.

    Per flattened VM ``j = r*V + v``, the incident virtual links padded to the
    max degree D (padding rows have ``inc_h == 0`` and ``inc_other == j``):
      * ``inc_other[J, D]`` -- flat index of the link's other endpoint VM
      * ``inc_h[J, D]``     -- bitrate (Mbps); 0 marks padding
      * ``inc_src[J, D]``   -- True where VM j is the link's source
    plus ``free_pos[M, 2]`` -- the (r, v) positions NOT pinned by Eq.(4) --
    and ``free_flat[M]``, the same positions as flat indices.
    """
    inc_other: torch.Tensor
    inc_h: torch.Tensor
    inc_src: torch.Tensor
    free_pos: torch.Tensor
    free_flat: torch.Tensor


class PlacementState(NamedTuple):
    """Live placement + load tensors, kept consistent by ``apply_move``."""
    X: torch.Tensor        # [R, V] int32, pins applied
    omega: torch.Tensor    # [P] GFLOPS
    tm: torch.Tensor       # [P, P] Mbps inter-node traffic matrix
    theta: torch.Tensor    # [P] Mbps LAN traffic
    lam: torch.Tensor      # [N] Mbps network-node traffic
    obj: torch.Tensor      # [] cached objective (power + penalty)


def build_aux(problem: PlacementProblem) -> PlacementAux:
    """Precompute per-VM incident-link lists (numpy; once per problem)."""
    src = problem.link_src.cpu().numpy()
    dst = problem.link_dst.cpu().numpy()
    h = problem.link_h.cpu().numpy()
    J = problem.R * problem.V
    per_vm: list = [[] for _ in range(J)]
    for l in range(len(src)):
        s, d = int(src[l]), int(dst[l])
        if s == d:
            # self-loop: one entry; its `other` endpoint moves with the VM
            per_vm[s].append((s, float(h[l]), True))
        else:
            per_vm[s].append((d, float(h[l]), True))
            per_vm[d].append((s, float(h[l]), False))
    D = max(1, max((len(e) for e in per_vm), default=1))
    inc_other = np.empty((J, D), dtype=np.int32)
    inc_other[:] = np.arange(J, dtype=np.int32)[:, None]
    inc_h = np.zeros((J, D), dtype=np.float32)
    inc_src = np.zeros((J, D), dtype=bool)
    for j, entries in enumerate(per_vm):
        for k, (o, hh, is_src) in enumerate(entries):
            inc_other[j, k] = o
            inc_h[j, k] = hh
            inc_src[j, k] = is_src
    fixed = problem.fixed_mask.cpu().numpy()
    free_pos = np.argwhere(~fixed).astype(np.int32)
    free_flat = (free_pos[:, 0] * problem.V + free_pos[:, 1]).astype(np.int32)
    t = lambda x: torch.as_tensor(x, device=problem.device)
    return PlacementAux(inc_other=t(inc_other), inc_h=t(inc_h),
                        inc_src=t(inc_src), free_pos=t(free_pos),
                        free_flat=t(free_flat))


def _snap(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(x.abs() < eps, torch.zeros_like(x), x)


def _proc_power_hard(om, th, E, C_pr, pi, pue, EL, share_pi):
    """Eq.(2) power of processing node(s) under hard activation indicators
    -- the single source the delta paths share."""
    phi = ((om > ACTIVE_EPS) | (th > ACTIVE_EPS)).float()
    return pue * (E * om + torch.ceil(om / C_pr) * pi + EL * th / 1e3
                  + phi * share_pi)


def _objective_from_loads(problem, omega, lam, theta) -> torch.Tensor:
    per_net, per_proc, viol = _hard_terms(problem, omega, lam, theta)
    return per_net.sum(-1) + per_proc.sum(-1) + PENALTY * viol


def batched_hard_loads(problem: PlacementProblem, Xc):
    """Loads + objective for a batch of hard placements ``Xc [C, R, V]``
    (pins applied): ``(omega [C, P], theta [C, P], lam [C, N], obj [C])``.
    The single source for chain-state initialization, shared by the delta
    anneal loop and the fused kernel wrapper."""
    Xc = as_placement(problem, Xc)
    omega, _, lam, theta = _loads(problem, Xc.flatten(-2))
    obj = _objective_from_loads(problem, omega, lam, theta)
    return omega, theta, lam, obj


def init_state(problem: PlacementProblem, X) -> PlacementState:
    """Full from-scratch state build (also the drift-killing refresh)."""
    X = apply_pins(problem, X)
    omega, tm, lam, theta = _loads(problem, X.reshape(-1), with_tm=True)
    obj = _objective_from_loads(problem, omega, lam, theta)
    return PlacementState(X=X, omega=omega, tm=tm, theta=theta, lam=lam,
                          obj=obj)


def _move_core(problem: PlacementProblem, aux: PlacementAux, X_flat,
               omega, theta, lam, j, p_new):
    """Entry-wise effect of moving flat VM ``j[c]`` to ``p_new[c]`` in each
    of C states (X_flat [C, J], omega/theta [C, P], lam [C, N]; j/p_new [C]
    int64).

    The theta/omega deltas are supported on {p_old, p_new} only (the q-side
    contributions of removal and insertion cancel for non-self links), so
    the move reduces to two per-node scalars plus the [N] route delta.
    Returns ``(p_old [C], idx [C, 2], om2 [C, 2], th2 [C, 2], lam2 [C, N],
    link_info)`` where ``om2``/``th2`` are the NEW (snapped) omega/theta at
    ``idx = [p_old, p_new]``.
    """
    p = problem
    P = p.P
    C = X_flat.shape[0]
    p_old = X_flat.gather(1, j[:, None])[:, 0].long()
    F_j = p.F_flat[j]
    h = aux.inc_h[j]                                   # [C, D]
    is_src = aux.inc_src[j]                            # [C, D]
    other = aux.inc_other[j].long()                    # [C, D]
    is_self = other == j[:, None]
    q = X_flat.gather(1, other).long()                 # [C, D]
    po, pn = p_old[:, None], p_new[:, None]
    q_rm = torch.where(is_self, po, q)
    q_in = torch.where(is_self, pn, q)
    # signed bitrates: -h for the removal leg, +h for the insertion leg
    hh = torch.cat([-h, h], 1)                         # [C, 2D]
    q2 = torch.cat([q_rm, q_in], 1)                    # [C, 2D]
    H_tot = h.sum(1)
    sr = (h * (q_rm == po)).sum(1)
    si = (h * (q_in == pn)).sum(1)
    # theta delta at p_old / p_new (all other entries cancel exactly)
    alpha = -(H_tot - sr) + (hh * (q2 == po)).sum(1)
    beta = (H_tot - si) + (hh * (q2 == pn)).sum(1)
    # lam: the two touched routes per link (ordered pair respects direction)
    idx_rm = torch.where(is_src, po * P + q_rm, q_rm * P + po)
    idx_in = torch.where(is_src, pn * P + q_in, q_in * P + pn)
    idx2 = torch.cat([idx_rm, idx_in], 1)              # [C, 2D]
    if p.route_dense is not None:
        d_lam = torch.einsum("cd,cdn->cn", hh, p.route_dense[idx2])
    else:
        ids2 = p.route_flat[idx2]                      # [C, 2D, K]
        d_lam = _scatter_rows(p.N + 1, ids2.reshape(C, -1),
                              hh[:, :, None].expand(ids2.shape)
                              .reshape(C, -1))[:, :p.N]
    lam2 = _snap(lam + d_lam, SNAP_MBPS)

    idx = torch.stack([p_old, p_new], 1)               # [C, 2]
    sm = (p_old == p_new).float()
    # degenerate move: fold the (exactly cancelling) deltas together so both
    # entries see "no change"
    d_om = torch.stack([-F_j + sm * F_j, F_j - sm * F_j], 1)
    d_th = torch.stack([alpha + sm * beta, beta + sm * alpha], 1)
    om2 = _snap(omega.gather(1, idx) + d_om, SNAP_GFLOPS)
    th2 = _snap(theta.gather(1, idx) + d_th, SNAP_MBPS)
    return p_old, idx, om2, th2, lam2, (h, is_src, q_rm, q_in)


def _delta_objective(p: PlacementProblem, omega, theta, lam,
                     idx, om2, th2, lam2) -> torch.Tensor:
    """Objective change [C], summing only changed terms: processing terms
    at the two entries ``idx``; network terms differenced full-width, where
    untouched entries give exact zeros."""
    om, th = omega.gather(1, idx), theta.gather(1, idx)            # [C, 2]
    E, Cpr, pi, pue, EL, share_pi, cap_pr, C_lan = p.proc_pack[:, idx]
    relu = torch.relu
    proc = lambda o, t: _proc_power_hard(o, t, E, Cpr, pi, pue, EL, share_pi)
    d_proc = (proc(om2, th2) - proc(om, th)).sum(-1)
    d_viol = (relu(om2 - cap_pr) - relu(om - cap_pr)
              + relu(th2 / 1e3 - C_lan) - relu(th / 1e3 - C_lan)).sum(-1)
    beta = (lam > ACTIVE_EPS).float()
    beta2 = (lam2 > ACTIVE_EPS).float()
    d_net = (p.pue_net * (p.eps * (lam2 - lam) / 1e3
                          + (beta2 - beta) * p.idle_share * p.pi_net)).sum(-1)
    d_viol = d_viol + (relu(lam2 / 1e3 - p.C_net)
                       - relu(lam / 1e3 - p.C_net)).sum(-1)
    return d_proc + d_net + PENALTY * d_viol


def _one(problem: PlacementProblem, state: PlacementState, r: int, v: int,
         p_new):
    """Batch-of-one operands of a single-state move; ``r`` / ``v`` are ints
    or (under ``torch.func.vmap``) int tensors."""
    dev = problem.device
    jv = r * problem.V + v
    # an int is filled on the device: a host-to-device copy would wait for
    # the queue
    j = (jv.long().reshape(1) if torch.is_tensor(jv)
         else torch.full((1,), jv, device=dev))
    pn = torch.as_tensor(p_new, device=dev).long().reshape(1)
    return (state.X.reshape(1, -1), state.omega[None], state.theta[None],
            state.lam[None], j, pn)


def delta_move(problem: PlacementProblem, aux: PlacementAux,
               state: PlacementState, r: int, v: int, p_new) -> torch.Tensor:
    """Exact objective change of moving VM (r, v) to node ``p_new``;
    (r, v) must be a free (non-pinned) position."""
    Xf, om, th, lm, j, pn = _one(problem, state, r, v, p_new)
    _, idx, om2, th2, lm2, _ = _move_core(problem, aux, Xf, om, th, lm, j,
                                          pn)
    return _delta_objective(problem, om, th, lm, idx, om2, th2, lm2)[0]


def apply_move(problem: PlacementProblem, aux: PlacementAux,
               state: PlacementState, r: int, v: int,
               p_new) -> PlacementState:
    """Commit a single-VM move, updating every load tensor incrementally
    (returns a new state; ``state`` is left as it was)."""
    Xf, om, th, lm, j, pn = _one(problem, state, r, v, p_new)
    p_old, idx, om2, th2, lm2, (h, is_src, q_rm, q_in) = _move_core(
        problem, aux, Xf, om, th, lm, j, pn)
    delta = _delta_objective(problem, om, th, lm, idx, om2, th2, lm2)[0]
    po, pn1 = p_old[:, None], pn[:, None]
    rows = torch.cat([torch.where(is_src, po, q_rm),
                      torch.where(is_src, pn1, q_in)], 1)[0]
    cols = torch.cat([torch.where(is_src, q_rm, po),
                      torch.where(is_src, q_in, pn1)], 1)[0]
    vals = torch.cat([-h, h], 1)[0]
    tm2 = _snap(state.tm.index_put((rows, cols), vals, accumulate=True),
                SNAP_MBPS)
    X2 = state.X.reshape(-1).scatter(0, j, pn.to(state.X.dtype))
    return PlacementState(X=X2.reshape(state.X.shape),
                          omega=om.scatter(1, idx, om2)[0], tm=tm2,
                          theta=th.scatter(1, idx, th2)[0],
                          lam=lm2[0], obj=state.obj + delta)


def delta_sweep(problem: PlacementProblem, aux: PlacementAux,
                state: PlacementState, r: int, v: int) -> torch.Tensor:
    """Absolute objective of moving VM (r, v) to EVERY node: [P].

    Removal once, then touched-entries scoring of all P insertions: placing
    VM j at candidate ``a`` changes the processing terms at ``a`` only, and
    the network terms only at the <= D*K route ids of the routes a <-> q_k
    (``ids [P, D, K]``).  A node shared by several of the candidate's
    routes sees ONE aggregated traffic delta before the beta/relu
    nonlinearities (cross-route id matches; only the first occurrence
    scores).  Entry ``p_old`` reproduces the current objective.
    """
    p = problem
    P, N = p.P, p.N
    dev = p.device
    j = r * p.V + v
    X_flat = state.X.reshape(-1)
    p_old = X_flat[j].long()
    F_j = p.F_flat[j]
    h = aux.inc_h[j]
    is_src = aux.inc_src[j]
    other = aux.inc_other[j].long()
    is_self = other == j
    q = X_flat[other].long()
    q_rm = torch.where(is_self, p_old, q)
    zero = torch.zeros((), device=dev)
    h_ns = torch.where(is_self, zero, h)      # non-self bitrates
    h_s = torch.where(is_self, h, zero)
    nodes = torch.arange(P, device=dev)

    # ---- removal (exact state with VM j taken out) ----------------------
    e_po = (nodes == p_old).float()
    oh_qr = (q_rm[:, None] == nodes).float()                    # [D, P]
    same_r = (q_rm == p_old).float()
    omega_r = state.omega - F_j * e_po
    theta_r = (state.theta - (h.sum() - (h * same_r).sum()) * e_po
               - (h[:, None] * oh_qr).sum(0))
    idx_rm = torch.where(is_src, p_old * P + q_rm, q_rm * P + p_old)
    ids_rm = p.route_flat[idx_rm]                               # [D, K]
    lam_r = state.lam - _scatter_rows(
        N + 1, ids_rm.reshape(-1), h[:, None].expand(ids_rm.shape)
        .reshape(-1))[:N]

    # ---- candidate-independent insertion loads --------------------------
    add_q = (h_ns[:, None] * (q[:, None] == nodes).float()).sum(0)
    diag_add = h_ns.sum() - add_q + h_s.sum()                   # [P]
    theta_i = theta_r + add_q                                   # [P]
    omega_b = _snap(omega_r, SNAP_GFLOPS)
    theta_b = _snap(theta_i, SNAP_MBPS)
    lam_b = _snap(lam_r, SNAP_MBPS)

    # ---- base objective (candidate-independent) -------------------------
    per_net_b, per_proc_b, viol_b = _hard_terms(p, omega_b, lam_b, theta_b)
    relu = torch.relu
    base = per_net_b.sum() + per_proc_b.sum() + PENALTY * viol_b

    # ---- processing correction at the candidate node (O(1) each) --------
    om_new = _snap(omega_r + F_j, SNAP_GFLOPS)
    th_new = _snap(theta_i + diag_add, SNAP_MBPS)
    cap_pr = p.NS * p.C_pr
    d_proc = _proc_power_hard(om_new, th_new, p.E, p.C_pr, p.pi_pr,
                              p.pue_pr, p.EL,
                              p.lan_share * p.pi_lan) - per_proc_b
    d_viol_pr = (relu(om_new - cap_pr) - relu(omega_b - cap_pr)
                 + relu(th_new / 1e3 - p.C_lan)
                 - relu(theta_b / 1e3 - p.C_lan))

    # ---- network correction on the touched route ids --------------------
    ids_src = p.route_long[:, q, :]                             # [P, D, K]
    ids_dst = p.route_long[q, :, :].transpose(0, 1)             # [P, D, K]
    ids3 = torch.where(is_src[None, :, None], ids_src, ids_dst)
    D = ids3.shape[1]
    valid3 = ids3 < N
    # each route's own ids are unique, so duplicates occur only ACROSS
    # routes: pairwise [P, K, K] id matches mark later occurrences and
    # accumulate the other routes' bitrates onto the first one
    dup = [torch.zeros_like(valid3[:, 0]) for _ in range(D)]
    tot = [torch.zeros(ids3[:, 0].shape, device=dev) for _ in range(D)]
    for d2 in range(D):
        for d1 in range(d2):
            eq = ids3[:, d1, :, None] == ids3[:, d2, None, :]   # [P, K, K]
            in2 = eq.any(dim=2)         # route-d1 entry also on route d2
            in1 = eq.any(dim=1)         # route-d2 entry also on route d1
            tot[d1] = tot[d1] + h_ns[d2] * in2
            tot[d2] = tot[d2] + h_ns[d1] * in1
            dup[d2] = dup[d2] | in1
    first = valid3 & ~torch.stack(dup, dim=1)                   # [P, D, K]
    tot_other = torch.stack(tot, dim=1)                         # [P, D, K]

    # one merged [6, P, D, K] gather (sentinel id N hits the zero column)
    tbl = torch.stack([lam_r, lam_b, p.eps, p.pue_net,
                       p.idle_share * p.pi_net, p.C_net])
    tblp = torch.cat([tbl, torch.zeros((6, 1), device=dev)], dim=1)
    lam_raw, lam_old, eps_g, pue_g, idle_g, cnet_g = tblp[:, ids3]
    lam_new = _snap(lam_raw + h_ns[None, :, None] + tot_other, SNAP_MBPS)
    beta_d = (lam_new > ACTIVE_EPS).float() - (lam_old > ACTIVE_EPS).float()
    use = first.float()
    d_net = (use * pue_g * (eps_g * (lam_new - lam_old) / 1e3
                            + beta_d * idle_g)).sum((-1, -2))   # [P]
    d_viol_net = (use * (relu(lam_new / 1e3 - cnet_g)
                         - relu(lam_old / 1e3 - cnet_g))).sum((-1, -2))
    return (base + d_proc + d_net
            + PENALTY * (d_viol_pr + d_viol_net))


# ---------------------------------------------------------------------------
# Online state operations: service-granular attach / detach / warm start
# ---------------------------------------------------------------------------
#
# The online regime mutates one SERVICE at a time.  Every virtual link is
# intra-service, so one service's load contribution is separable: O(V*(N+P))
# host work per event (on ``PlacementProblem.host``) instead of the
# O(R*V*P + L*P^2) full ``_loads`` contraction.

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pins_np(problem: PlacementProblem, X: np.ndarray) -> np.ndarray:
    h = problem.host
    return np.where(h.fixed_mask, h.fixed_node, X).astype(np.int32)


def service_loads(problem: PlacementProblem, X, rows
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Load contribution (omega[P], tm[P, P], theta[P], lam[N]) of the
    services in ``rows`` under placement ``X`` -- exactly the slice of
    ``_loads`` supported on those services' VMs and virtual links.  Host
    numpy, accumulated in float64 and returned as float32."""
    p = problem
    h = p.host
    X = _host(X)
    Xf = X.reshape(-1)
    P, N, V = p.P, p.N, p.V
    rows = np.atleast_1d(np.asarray(rows, np.int64))
    omega = np.zeros(P, np.float64)  # tracelint: allow[CFN102]
    tm = np.zeros((P, P), np.float64)  # tracelint: allow[CFN102]
    theta = np.zeros(P, np.float64)  # tracelint: allow[CFN102]
    lam = np.zeros(N, np.float64)  # tracelint: allow[CFN102]
    F = np.asarray(h.F, np.float64)  # tracelint: allow[CFN102]
    np.add.at(omega, X[rows].reshape(-1), F[rows].reshape(-1))
    ls, ld = h.link_src, h.link_dst
    lh = np.asarray(h.link_h, np.float64)  # tracelint: allow[CFN102]
    sel = np.isin(ls // V, rows)
    rt = h.route_idx
    for s, d, hh in zip(ls[sel], ld[sel], lh[sel]):
        b, e = int(Xf[s]), int(Xf[d])
        tm[b, e] += hh
        theta[b] += hh
        if e != b:
            theta[e] += hh
            ids = rt[b, e]
            lam[ids[ids < N]] += hh    # route ids are unique per route
    f32 = lambda a: a.astype(np.float32)
    return f32(omega), f32(tm), f32(theta), f32(lam)


def _state_from_loads(problem: PlacementProblem, X, omega, tm, theta,
                      lam) -> PlacementState:
    """A state from carried loads (tensors or host arrays), snapped as the
    delta engine snaps; the objective from the loads in O(P + N)."""
    t = lambda a, eps: _snap(to_tensor(a, problem.device, torch.float32),
                             eps)
    omega, theta = t(omega, SNAP_GFLOPS), t(theta, SNAP_MBPS)
    lam = t(lam, SNAP_MBPS)
    return PlacementState(X=as_placement(problem, X), omega=omega,
                          tm=t(tm, SNAP_MBPS), theta=theta, lam=lam,
                          obj=_objective_from_loads(problem, omega, lam,
                                                    theta))


def _add_loads(state: PlacementState, d, sign: float):
    dev = state.omega.device
    return tuple(s + sign * torch.as_tensor(x, device=dev)
                 for s, x in zip((state.omega, state.tm, state.theta,
                                  state.lam), d))


def attach_vsrs(problem: PlacementProblem, state: PlacementState,
                rows, X_rows=None) -> PlacementState:
    """Add the load contribution of services ``rows`` to a live state.

    ``state`` must NOT already carry those services' loads (it came from
    ``detach_vsrs`` or from ``warm_state`` over a problem that grew).  If
    ``X_rows`` [len(rows), V] is given, it is written into ``state.X`` first
    (pins applied); otherwise the placements already in ``state.X`` are
    attached.  O(len(rows) * V * (N + P)); the objective is rebuilt from
    the updated loads in O(P + N).
    """
    X = _host(state.X).copy()
    if X_rows is not None:
        X[np.atleast_1d(np.asarray(rows, np.int64))] = _host(X_rows)
        X = _pins_np(problem, X)
    d = service_loads(problem, X, rows)
    return _state_from_loads(problem, X, *_add_loads(state, d, 1.0))


def detach_vsrs(problem: PlacementProblem, state: PlacementState,
                rows) -> PlacementState:
    """Remove the load contribution of services ``rows`` from a live state:
    the inverse of ``attach_vsrs``.  The returned loads and objective
    describe the substrate as if those services were not embedded (their
    ``state.X`` rows become dead entries the caller drops via
    ``warm_state``'s row map)."""
    X = _host(state.X)
    d = service_loads(problem, X, rows)
    return _state_from_loads(problem, X, *_add_loads(state, d, -1.0))


def warm_state(problem_new: PlacementProblem, prev_X,
               prev_loads: Optional[tuple] = None,
               row_map: Optional[Sequence[int]] = None,
               init_node: Optional[int] = None) -> PlacementState:
    """Carry a previous placement into a grown / shrunk problem.

    ``prev_X`` [R_old, V_old] is the placement being carried;
    ``row_map[i] = j`` maps new row i to previous row j (``-1`` marks a
    fresh service).  Defaults to identity on the first min(R_old, R_new)
    rows with fresh rows appended -- the arrival case.  Column growth (a
    wider VM padding) fills new columns with the row's pinned source
    (zero-demand pad VMs never affect the objective); column shrinkage
    drops pad columns.  Fresh rows start pinned-input + ``init_node``
    (default: the row's source node).

    With ``prev_loads`` (omega, tm, theta, lam) carried from a previous
    state whose services match the SURVIVING rows (the caller detached
    departures first), the state is assembled in O(fresh * V * (N + P))
    instead of a full rebuild; otherwise it is ``init_state``'s.
    """
    p = problem_new
    h = p.host
    prev_X = _host(prev_X)
    R_old = prev_X.shape[0]
    V_old = prev_X.shape[1] if prev_X.ndim == 2 else 0
    R, V = p.R, p.V
    if row_map is None:
        row_map = list(range(min(R_old, R))) + [-1] * (R - min(R_old, R))
    row_map = list(row_map)
    if len(row_map) != R:
        raise ValueError(f"row_map has {len(row_map)} entries for R={R}")
    src_of = h.fixed_node[np.arange(R), np.argmax(h.fixed_mask, 1)]
    X = np.empty((R, V), dtype=np.int32)
    fresh: list = []
    for i, j in enumerate(row_map):
        fill = int(src_of[i]) if init_node is None else int(init_node)
        if j < 0:
            fresh.append(i)
            X[i] = fill
        else:
            k = min(V, V_old)
            X[i, :k] = prev_X[j, :k]
            X[i, k:] = fill
    X = _pins_np(p, X)
    if prev_loads is None:
        return init_state(p, X)
    state = _state_from_loads(p, X, *prev_loads)
    if fresh:
        state = attach_vsrs(p, state, fresh)
    return state


def attribute_power(problem: PlacementProblem, X,
                    breakdown: Optional[PowerBreakdown] = None,
                    n_rows: Optional[int] = None) -> np.ndarray:
    """Split ``breakdown.total`` across services: per-service watts [R]
    that sum to the total (float64).

    Each node's Eq.(2) power (proportional + idle servers + LAN) is shared
    among the services loading it, proportionally to their marginal energy
    there (E*omega_r + EL*theta_r); each network node's Eq.(1) power by the
    services' traffic shares lam_r.  ``breakdown`` may hold tensors or
    numpy arrays (``SolveResult.breakdown``).

    ``n_rows``: attribute over the first n_rows services only (the rows
    beyond are shape-bucketing pad rows with zero load; excluding them keeps
    the unattributable-idle residue split across REAL tenants so the
    returned watts still sum to the total).
    """
    p = problem
    X = _pins_np(p, _host(X))
    bd = evaluate(p, X) if breakdown is None else breakdown
    R = p.R if n_rows is None else int(n_rows)
    per_proc = np.asarray(_host(bd.per_proc), np.float64)  # tracelint: allow[CFN102]
    per_net = np.asarray(_host(bd.per_net), np.float64)  # tracelint: allow[CFN102]
    E = np.asarray(_host(p.E), np.float64)  # tracelint: allow[CFN102]
    EL = np.asarray(_host(p.EL), np.float64)  # tracelint: allow[CFN102]
    w_proc = np.zeros((R, p.P))
    w_net = np.zeros((R, p.N))
    for r in range(R):
        om, _, th, lm = service_loads(p, X, [r])
        present = (om > 0) | (th > 0)
        w_proc[r] = E * om + EL * th / 1e3 + 1e-12 * present
        w_net[r] = lm
    out = np.zeros(R)
    for W, per in ((w_proc, per_proc), (w_net, per_net)):
        tot = W.sum(axis=0)
        used = tot > 0
        share = np.where(used, W / np.where(used, tot, 1.0), 0.0)
        out += share @ per
        out += per[~used].sum() / max(R, 1)  # unattributable residue
    return out


def summarize(problem: PlacementProblem, topo: CFNTopology,
              X) -> Dict[str, float]:
    """Human-readable per-layer report (drives the Fig. 3 / Fig. 4 tables)."""
    bd = evaluate(problem, X)
    per_proc = bd.per_proc.cpu().numpy()
    omega = bd.omega.cpu().numpy()
    out = dict(total_w=float(bd.total), net_w=float(bd.net),
               proc_w=float(bd.proc), violation=float(bd.violation))
    for layer in ("iot", "af", "mf", "cdc"):
        idx = topo.layer_indices(layer)
        out[f"proc_w_{layer}"] = float(per_proc[idx].sum())
        out[f"gflops_{layer}"] = float(omega[idx].sum())
    return out
