"""CUDA kernels for the CFN placement objective (paper Eq. 1+2), with their
plain PyTorch versions.

  * ``placement_power_cuda`` (``csrc/placement_power.cu``) -- batched FULL
    evaluation of B candidate placements -> [B, 4] (objective, net W, proc
    W, violation); a thread-block cluster of
    ``placement_power_cluster_size(B)`` CTAs per candidate, reduced through
    distributed shared memory.  Replaces ``placement_power_tpu``
    (src/repro/kernels/placement_power.py:160).
  * ``fused_anneal_cuda`` (``csrc/fused_anneal.cu``) -- whole Metropolis
    chains, one launch for the whole schedule, one warp per chain with its
    state in shared memory, or with its placements X and best X in global
    memory where one chain's do not fit (``fused_anneal_variant`` picks
    the variant and the chains a block).  Replaces ``fused_anneal_tpu``
    (src/repro/kernels/placement_power.py:377).

``placement_power_ref`` and ``fused_anneal_ref`` compute the same functions
in plain PyTorch over the same operands; the CPU tests run them, and the
card's smoke run holds each kernel against its plain version.  A wrapper
given CUDA tensors launches its kernel or raises; ``kernels.ops`` picks the
plain version only for tensors on the CPU.  ``LAUNCHES`` counts kernel
launches (one per wrapper call that launched; the fused anneal's per
variant, ``fused_anneal`` and ``fused_anneal_global``), so a run can show
that its main path went through the kernels; each hook in
``LAUNCH_HOOKS`` (``telemetry.Telemetry.attach_traces``) is called with
the kernel's name at every launch.

Operands (``pack_problem`` / ``pack_aux``): ``route`` is the int32 CSR
route table ``[P*P, K]`` (sentinel N), read directly by both kernels --
never the TPU kernels' float ids or one-hot row selects.  ``proc_params``
``[9, P]`` = E, C_pr, NS, pi_pr, pue_pr, EL, C_lan, pi_lan, lan_share;
``net_params`` ``[5, N]`` = eps, C_net, pi_net, pue_net, idle_share.

Module constants mirror core.power (kernels stay import-clean of core).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Set, Tuple

import torch

from ..core.power import _scatter_rows
from . import _build

ACTIVE_EPS = 1.0e-6
PENALTY = 1.0e4
SNAP_GFLOPS = 1.0e-3
SNAP_MBPS = 1.0e-2

# the H100's streaming multiprocessors, and the shared memory one block may
# use (bytes)
N_SMS = 132
SMEM_PER_BLOCK = 232448
# the fused kernel's limits: 2D <= 64 routes (two 32-bit words of route
# bits), at most 32 slots a lane
FUSED_MAX_D = 32
FUSED_MAX_SLOTS = 1024
FUSED_LOG = 128

# csrc/placement_power.cu: warps a block (kThreads / 32)
PLACEMENT_POWER_WARPS = 8

# kernel launches since the last reset, per kernel (the fused anneal's per
# variant: state in shared memory, X and best X in global memory)
LAUNCHES: Dict[str, int] = {"placement_power": 0, "fused_anneal": 0,
                            "fused_anneal_global": 0}
# the distinct shapes that set a launch's shared memory, since import:
# ("placement_power", P, N) and ("fused_anneal", C, J, P, N, D, K)
LAUNCH_SHAPES: Set[tuple] = set()
# callables hook(kernel name), called at every launch LAUNCHES counts
LAUNCH_HOOKS: List = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    LAUNCHES[name] += 1
    if LAUNCH_HOOKS:
        for hook in list(LAUNCH_HOOKS):
            hook(name)


def placement_power_cluster_size(B: int) -> int:
    """CTAs per candidate of ``placement_power_cuda``: the largest power of
    two up to 8 that keeps B * cs within two CTAs per SM, so a small batch
    (the main path re-scores B = 32) still spreads over the 132 SMs, and a
    batch of 133 or more runs one CTA per candidate."""
    cs = 1
    while cs < 8 and B * 2 * cs <= 2 * N_SMS:
        cs *= 2
    return cs


def placement_power_launch_smem(P: int, N: int) -> int:
    """Dynamic shared memory ``placement_power_launch`` requests at P
    processing and N network nodes (``smem_bytes`` of
    ``csrc/placement_power.cu``): the warps' omega | theta copies [warps,
    2P], the half-warps' lambda copies [2 warps, N + 1] and the block's
    loads [2P + N + 1], float32."""
    warps = PLACEMENT_POWER_WARPS
    return (warps * 2 * P + 2 * warps * (N + 1) + 2 * P + N + 1) * 4


def fused_anneal_smem_bytes(J: int, P: int, N: int, D: int,
                            chains: int, global_x: bool = False) -> int:
    """Dynamic shared memory of one ``csrc/fused_anneal.cu`` block of
    ``chains`` chains (its ``param_bytes + chains * chain_bytes``); with
    ``global_x`` the chains' X and best X are in global memory instead."""
    up16 = lambda b: (b + 15) // 16 * 16
    params = up16(4 * (8 * P + 4 * (N + 1)))
    words = (2 * D + 31) // 32          # route bits per node id
    chain = up16(4 * ((N + 1) * words + (0 if global_x else 2 * J) + 2 * P
                      + (N + 1) + 4 * D + FUSED_LOG))
    return params + chains * chain


def fused_anneal_launch_smem(C: int, J: int, P: int, N: int, deg: int,
                             K: int) -> int:
    """Dynamic shared memory ``fused_anneal_launch`` requests for C chains
    of J VMs (``deg`` incident links a VM, K route slots): the block of
    the variant and chains a block ``fused_anneal_variant`` picks; 0
    where no variant takes the shape (no launch)."""
    variant, cpb = fused_anneal_variant(C, J, P, N, deg, K)
    if variant == "delta":
        return 0
    return fused_anneal_smem_bytes(J, P, N, deg, cpb, variant == "global")


def _chains_that_fit(J: int, P: int, N: int, D: int, global_x: bool) -> int:
    fit = 0
    while fit < 32 and fused_anneal_smem_bytes(
            J, P, N, D, fit + 1, global_x) <= SMEM_PER_BLOCK:
        fit += 1
    return fit


def fused_anneal_variant(C: int, J: int, P: int, N: int, D: int,
                         K: int) -> Tuple[str, int]:
    """Which ``fused_anneal_cuda`` variant runs C chains of J VMs (P
    processing nodes, N network nodes, D incident links a VM, K route
    slots), and how many chains a block: ``("shared", cpb)`` while one
    chain's state fits a block's shared memory (at P = 468, N = 126, D = 2:
    J <= 26267), else ``("global", cpb)``, the chains' X and best X in
    global memory.  cpb is one while the chains fit one to an SM (a
    step's latency is then the warp's alone), more once C exceeds the
    132 SMs, as many as the block's shared memory holds.

    ``("delta", 0)`` where no variant takes the shape: D > 32 or
    2 * D * K > 1024 (two 32-bit words of route bits, at most 32 slots a
    lane), or a block's per-node parameters and one chain's tables over
    the shared memory even without X.  ``anneal(backend="auto")`` then
    takes its ``"delta"`` backend, and ``fused_anneal_cuda`` raises.
    Raises ValueError only for a negative size."""
    if min(C, J, P, N, D, K) < 0:
        raise ValueError(f"negative size in C={C}, J={J}, P={P}, N={N}, "
                         f"D={D}, K={K}")
    if D > FUSED_MAX_D or 2 * D * K > FUSED_MAX_SLOTS:
        return "delta", 0
    per_sm = max(1, -(-C // N_SMS))
    for variant, global_x in (("shared", False), ("global", True)):
        fit = _chains_that_fit(J, P, N, D, global_x)
        if fit:
            return variant, min(fit, per_sm)
    return "delta", 0


def mask_proposals(j_prop: torch.Tensor, p_prop: torch.Tensor,
                   eligible: torch.Tensor, V: int) -> torch.Tensor:
    """Project proposal destinations onto per-row eligible sets: a
    destination outside its service row's eligible set becomes that row's
    first eligible node, so a chain is never asked to accept an ineligible
    move.  j_prop/p_prop [C, T] (flat VM index, node); eligible [R, P]."""
    el = eligible.to(torch.bool)
    rows = j_prop.long() // V
    ok = el[rows, p_prop.long()]
    fallback = el.to(torch.uint8).argmax(dim=1).to(p_prop.dtype)
    return torch.where(ok, p_prop, fallback[rows])


def pack_problem(problem) -> Tuple[torch.Tensor, ...]:
    """A ``core.power.PlacementProblem`` as kernel operands:
    ``(link_src, link_dst, F [J], link_h, route [P*P, K] int32,
    proc_params [9, P], net_params [5, N])``, all contiguous."""
    p = problem
    proc_params = torch.stack([p.E, p.C_pr, p.NS, p.pi_pr, p.pue_pr,
                               p.EL, p.C_lan, p.pi_lan, p.lan_share])
    net_params = torch.stack([p.eps, p.C_net, p.pi_net, p.pue_net,
                              p.idle_share])
    return (p.link_src.contiguous(), p.link_dst.contiguous(),
            p.F.reshape(-1).contiguous(), p.link_h.contiguous(),
            p.route_idx.reshape(p.P * p.P, p.K).contiguous(),
            proc_params.contiguous(), net_params.contiguous())


def pack_aux(aux) -> Tuple[torch.Tensor, ...]:
    """A ``core.power.PlacementAux`` as fused-kernel operands:
    ``(inc_other [J, D] int32, inc_h [J, D] f32, inc_src [J, D] int32)``."""
    return (aux.inc_other.to(torch.int32).contiguous(),
            aux.inc_h.to(torch.float32).contiguous(),
            aux.inc_src.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _terms(omega, theta, lam, pp, nn):
    """Eq.(1)/(2) from loads -> [..., 4] (objective, net, proc, violation);
    omega/theta [..., P], lam [..., N]."""
    E, C_pr, NS, pi_pr, pue_pr, EL, C_lan, pi_lan, lan_share = pp
    eps, C_net, pi_net, pue_net, idle_share = nn
    n_srv = torch.ceil(omega / C_pr)
    beta = (lam > ACTIVE_EPS).float()
    phi = ((omega > ACTIVE_EPS) | (theta > ACTIVE_EPS)).float()
    per_net = pue_net * (eps * lam / 1e3 + beta * idle_share * pi_net)
    per_proc = pue_pr * (E * omega + n_srv * pi_pr + EL * theta / 1e3
                         + phi * lan_share * pi_lan)
    relu = torch.relu
    violation = (relu(omega - NS * C_pr).sum(-1)
                 + relu(lam / 1e3 - C_net).sum(-1)
                 + relu(theta / 1e3 - C_lan).sum(-1))
    net, proc = per_net.sum(-1), per_proc.sum(-1)
    return torch.stack([net + proc + PENALTY * violation, net, proc,
                        violation], -1)


def placement_power_ref(X, link_src, link_dst, F, H, route, proc_params,
                        net_params) -> torch.Tensor:
    """Plain version of ``placement_power_cuda``: X [B, J] int32 (pins
    applied) -> [B, 4]."""
    B, J = X.shape
    P, N = proc_params.shape[1], net_params.shape[1]
    K = route.shape[1]
    Xl = X.long()
    omega = _scatter_rows(P, Xl, F.expand(B, J))
    a, b = Xl[:, link_src.long()], Xl[:, link_dst.long()]          # [B, L]
    h = H.expand(a.shape)
    theta = _scatter_rows(P, torch.cat([a, b], 1),
                       torch.cat([h, h * (a != b)], 1))
    ids = route.long()[a * P + b]                                  # [B, L, K]
    lam = _scatter_rows(N + 1, ids.reshape(B, -1),
                     H[None, :, None].expand(B, -1, K).reshape(B, -1))
    return _terms(omega, theta, lam[:, :N], proc_params, net_params)


def _div1e3(x: torch.Tensor) -> torch.Tensor:
    """x / 1000 rounded as IEEE division, on any device.  On CUDA, PyTorch
    divides by a Python number as a product with its float reciprocal,
    which can differ from the quotient in the last bit; dividing by a
    tensor divides exactly, as the kernel does (``div1e3``)."""
    return x / torch.full((), 1e3, dtype=x.dtype, device=x.device)


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (M slots) in the kernel's order: lane l sums
    slots l, l + 32, ... in turn, then a butterfly over the 32 lanes
    (``__shfl_xor_sync`` at offsets 16, 8, 4, 2, 1)."""
    C, M = v.shape
    v = torch.nn.functional.pad(v, (0, (-M) % 32)).reshape(C, -1, 32)
    lanes = torch.zeros_like(v[:, 0])
    for i in range(v.shape[1]):
        lanes = lanes + v[:, i]
    idx = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    return lanes[:, 0]


def fused_anneal_ref(X, j_prop, p_prop, u_prop, temps, inc_other, inc_h,
                     inc_src, omega0, theta0, lam0, obj0, F, route,
                     proc_params, net_params,
                     rows_read: Optional[torch.Tensor] = None):
    """Plain version of ``fused_anneal_cuda``: the same per-step arithmetic,
    vectorized over the C chains, with every sum taken in the kernel's
    order (the D- and 2D-term sums in turn, a node id's signed bitrates in
    route order, d_net and d_viol as one warp sums them: ``_warp_sum``), so
    the two accept the same moves.  A route row's ids are distinct (the
    router's shortest paths), so an id is shared only across routes.

    X [C, J] int32 starting placements (pins applied); j_prop/p_prop/u_prop
    [C, T]; temps [T]; inc_* [J, D]; omega0/theta0 [C, P], lam0 [C, N],
    obj0 [C] starting loads.  Returns (best_X [C, J] int32, stats [C, 2] =
    (best objective, final objective)).  ``rows_read`` (bool [P*P],
    optional) is marked with every route row a step reads -- the data the
    kernel's bound counts.
    """
    C, J = X.shape
    T = temps.shape[0]
    D = inc_h.shape[1]
    P, N = proc_params.shape[1], net_params.shape[1]
    K = route.shape[1]
    dev = X.device
    E, C_pr, NS, pi_pr, pue_pr, EL, C_lan, pi_lan, lan_share = proc_params
    eps_n, C_net, pi_net, pue_net, idle_share = net_params
    # per-node operands, gathered at once: [8, P] and [4, N + 1]
    pk = torch.stack([E, C_pr, pi_pr, pue_pr, EL, lan_share * pi_lan,
                      NS * C_pr, C_lan])
    nk = torch.nn.functional.pad(
        torch.stack([eps_n, pue_net, idle_share * pi_net, C_net]), (0, 1))
    route_l = route.long()
    inc_o, inc_s = inc_other.long(), inc_src.bool()
    M = 2 * D * K
    earlier = torch.ones(2 * D, 2 * D, dtype=torch.bool, device=dev).tril(-1)
    relu = torch.relu
    snap = lambda x, e: torch.where(x.abs() < e, torch.zeros_like(x), x)

    def proc(om, th, g):
        Ep, Cp, pip, puep, ELp, spp = g[:6]
        phi = ((om > ACTIVE_EPS) | (th > ACTIVE_EPS)).float()
        return puep * (Ep * om + torch.ceil(om / Cp) * pip + _div1e3(ELp * th)
                       + phi * spp)

    Xc = X.clone()
    omega, theta = omega0.clone(), theta0.clone()
    lam = torch.nn.functional.pad(lam0, (0, 1))     # slot N absorbs writes
    obj = obj0.clone()
    bX, bobj = Xc.clone(), obj.clone()
    for t in range(T):
        j, pn = j_prop[:, t].long(), p_prop[:, t].long()
        po = Xc.gather(1, j[:, None])[:, 0].long()
        F_j = F[j]
        h, o, s = inc_h[j], inc_o[j], inc_s[j]                     # [C, D]
        self_ = o == j[:, None]
        q = Xc.gather(1, o).long()
        q_rm = torch.where(self_, po[:, None], q)
        q_in = torch.where(self_, pn[:, None], q)
        # ---- processing terms at p_old / p_new --------------------------
        hh = torch.cat([-h, h], 1)                                 # [C, 2D]
        q2 = torch.cat([q_rm, q_in], 1)
        H_tot = sr = si = torch.zeros_like(F_j)
        for d in range(D):
            H_tot = H_tot + h[:, d]
            sr = sr + h[:, d] * (q_rm[:, d] == po)
            si = si + h[:, d] * (q_in[:, d] == pn)
        s_old = s_new = torch.zeros_like(F_j)
        for r in range(2 * D):
            s_old = s_old + hh[:, r] * (q2[:, r] == po)
            s_new = s_new + hh[:, r] * (q2[:, r] == pn)
        alpha = -(H_tot - sr) + s_old
        beta = (H_tot - si) + s_new
        sm = (po == pn).float()
        idx = torch.stack([po, pn], 1)                             # [C, 2]
        d_om = torch.stack([-F_j + sm * F_j, F_j - sm * F_j], 1)
        d_th = torch.stack([alpha + sm * beta, beta + sm * alpha], 1)
        om, th = omega.gather(1, idx), theta.gather(1, idx)
        om2 = snap(om + d_om, SNAP_GFLOPS)
        th2 = snap(th + d_th, SNAP_MBPS)
        g = pk[:, idx]                                             # [8, C, 2]
        d_proc = (proc(om2, th2, g) - proc(om, th, g)).sum(1)
        cap, Cl = g[6], g[7]
        d_viol = (relu(om2 - cap) - relu(om - cap)
                  + relu(_div1e3(th2) - Cl) - relu(_div1e3(th) - Cl)).sum(1)
        # ---- network terms on the touched route ids ---------------------
        a2 = torch.cat([po[:, None].expand(-1, D),
                        pn[:, None].expand(-1, D)], 1)
        s2 = torch.cat([s, s], 1)
        ridx = torch.where(s2, a2 * P + q2, q2 * P + a2)           # [C, 2D]
        if rows_read is not None:
            rows_read[ridx[hh != 0]] = True
        ids = route_l[ridx]                                        # [C,2D,K]
        ids = torch.where((hh != 0)[:, :, None], ids, N).reshape(C, M)
        valid = ids < N
        # on[c, s, r]: slot s's id lies on route r (slot s = r * K + k)
        on = ((ids[:, :, None] == ids[:, None, :]) & valid[:, None, :]
              ).reshape(C, M, 2 * D, K).any(-1)
        r_of = torch.arange(M, device=dev) // K
        # one aggregated signed bitrate per node id, summed in route order
        # and scored at its first slot (no earlier route holds the id)
        tot = torch.zeros(C, M, dtype=hh.dtype, device=dev)
        for r in range(2 * D):
            tot = tot + torch.where(on[:, :, r], hh[:, r:r + 1], 0.0)
        first = valid & ~(on & earlier[r_of]).any(-1)
        lam_old = lam.gather(1, ids)
        lam_new = snap(lam_old + tot, SNAP_MBPS)
        eps_g, pue_g, idle_g, cnet_g = nk[:, ids]                  # [4, C, M]
        b_d = (lam_new > ACTIVE_EPS).float() - (lam_old > ACTIVE_EPS).float()
        zero = torch.zeros_like(lam_new)
        d_net = _warp_sum(torch.where(first, pue_g * (
            _div1e3(eps_g * (lam_new - lam_old)) + b_d * idle_g), zero))
        d_viol = d_viol + _warp_sum(torch.where(first, (
            relu(_div1e3(lam_new) - cnet_g) - relu(_div1e3(lam_old) - cnet_g)),
            zero))
        delta = d_proc + d_net + PENALTY * d_viol
        # ---- Metropolis accept, commit, best tracking -------------------
        Tt = torch.clamp_min(temps[t], 1e-9)
        acc = (delta < 0) | (u_prop[:, t] < torch.exp(
            -torch.clamp_min(delta, 0.0) / Tt))
        a1 = acc[:, None]
        Xc = torch.where(a1, Xc.scatter(1, j[:, None],
                                        pn[:, None].to(Xc.dtype)), Xc)
        omega = torch.where(a1, omega.scatter(1, idx, om2), omega)
        theta = torch.where(a1, theta.scatter(1, idx, th2), theta)
        wr = torch.where(first & a1, ids, N)
        lam = lam.scatter(1, wr, lam_new)
        obj = torch.where(acc, obj + delta, obj)
        better = obj < bobj
        bX = torch.where(better[:, None], Xc, bX)
        bobj = torch.where(better, obj, bobj)
    return bX, torch.stack([bobj, obj], 1)


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_range(t: torch.Tensor, hi: int, name: str) -> None:
    """Every entry of the index tensor ``t`` in [0, hi) (one host sync)."""
    if t.numel():
        lo_v, hi_v = (int(x) for x in torch.aminmax(t))
        if lo_v < 0 or hi_v >= hi:
            raise ValueError(f"{name} holds ids outside [0, {hi}): "
                             f"[{lo_v}, {hi_v}]")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(fn, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def placement_power_cuda(X, link_src, link_dst, F, H, route, proc_params,
                         net_params) -> torch.Tensor:
    """Launch ``csrc/placement_power.cu``: X [B, J] int32 (pins applied),
    link_src/link_dst [L] int32, F [J], H [L], route [P*P, K] int32,
    proc_params [9, P], net_params [5, N] -> [B, 4] float32."""
    B, J = X.shape
    L = link_src.shape[0]
    P, N = proc_params.shape[1], net_params.shape[1]
    K = route.shape[1]
    i32, f32 = torch.int32, torch.float32
    for t, nm, dt, sh in ((X, "X", i32, (B, J)),
                          (link_src, "link_src", i32, (L,)),
                          (link_dst, "link_dst", i32, (L,)),
                          (F, "F", f32, (J,)), (H, "H", f32, (L,)),
                          (route, "route", i32, (P * P, K)),
                          (proc_params, "proc_params", f32, (9, P)),
                          (net_params, "net_params", f32, (5, N))):
        _check(t, nm, dt, sh)
    _check_range(X, P, "X")
    out = torch.empty((B, 4), dtype=f32, device=X.device)
    if B == 0:
        return out
    placement_power_launch(out, X, link_src, link_dst, F, H, route,
                           proc_params, net_params)
    _count_launch("placement_power")
    return out


def placement_power_launch(out, X, link_src, link_dst, F, H, route,
                           proc_params, net_params) -> None:
    """The launch of ``placement_power_cuda`` into ``out`` [B, 4], without
    its checks, its host sync or its count (so a CUDA graph can capture
    it); B >= 1."""
    B, J = X.shape
    P, N, K = proc_params.shape[1], net_params.shape[1], route.shape[1]
    LAUNCH_SHAPES.add(("placement_power", P, N))
    lib = _build.library("placement_power")
    _launch(lib.placement_power_launch, _ptr(X), _ptr(link_src),
            _ptr(link_dst), _ptr(F), _ptr(H), _ptr(route), _ptr(proc_params),
            _ptr(net_params), _ptr(out), B, J, link_src.shape[0], P, N, K,
            placement_power_cluster_size(B))


def fused_anneal_cuda(X, j_prop, p_prop, u_prop, temps, inc_other, inc_h,
                      inc_src, omega0, theta0, lam0, obj0, F, route,
                      proc_params, net_params):
    """Launch ``csrc/fused_anneal.cu`` (one warp per chain) in the variant
    ``fused_anneal_variant`` picks.  Operands as ``fused_anneal_ref``;
    returns (best_X [C, J] int32, stats [C, 2]).  Raises where no variant
    takes the shape: D > 32 incident links per VM or M = 2 * D * K > 1024
    route slots."""
    C, J = X.shape
    T = temps.shape[0]
    D = inc_h.shape[1]
    P, N = proc_params.shape[1], net_params.shape[1]
    K = route.shape[1]
    i32, f32 = torch.int32, torch.float32
    for t, nm, dt, sh in ((X, "X", i32, (C, J)),
                          (j_prop, "j_prop", i32, (C, T)),
                          (p_prop, "p_prop", i32, (C, T)),
                          (u_prop, "u_prop", f32, (C, T)),
                          (temps, "temps", f32, (T,)),
                          (inc_other, "inc_other", i32, (J, D)),
                          (inc_h, "inc_h", f32, (J, D)),
                          (inc_src, "inc_src", i32, (J, D)),
                          (omega0, "omega0", f32, (C, P)),
                          (theta0, "theta0", f32, (C, P)),
                          (lam0, "lam0", f32, (C, N)),
                          (obj0, "obj0", f32, (C,)), (F, "F", f32, (J,)),
                          (route, "route", i32, (P * P, K)),
                          (proc_params, "proc_params", f32, (9, P)),
                          (net_params, "net_params", f32, (5, N))):
        _check(t, nm, dt, sh)
    _check_range(X, P, "X")
    _check_range(p_prop, P, "p_prop")
    _check_range(j_prop, J, "j_prop")
    variant, _ = fused_anneal_variant(C, J, P, N, D, K)
    if variant == "delta":
        raise ValueError(f"fused_anneal_cuda takes D <= {FUSED_MAX_D} and "
                         f"2 * D * K <= {FUSED_MAX_SLOTS}, got D={D}, K={K} "
                         f"(P={P}, N={N})")
    bX = torch.empty((C, J), dtype=i32, device=X.device)
    stats = torch.empty((C, 2), dtype=f32, device=X.device)
    if C == 0:
        return bX, stats
    fused_anneal_launch(bX, stats, X, j_prop, p_prop, u_prop, temps,
                        inc_other, inc_h, inc_src, omega0, theta0, lam0,
                        obj0, F, route, proc_params, net_params)
    _count_launch("fused_anneal" if variant == "shared"
                  else "fused_anneal_global")
    return bX, stats


def fused_anneal_launch(bX, stats, *args) -> None:
    """The launch of ``fused_anneal_cuda`` into ``bX`` [C, J] and ``stats``
    [C, 2], without its checks, its host syncs or its count (so a CUDA
    graph can capture it); ``args`` as ``fused_anneal_cuda``'s, C >= 1, a
    shape some variant takes.  The global variant's X lives in a [C, J]
    scratch allocated here."""
    X, temps, inc_h, route, proc_params, net_params = (
        args[0], args[4], args[6], args[13], args[14], args[15])
    C, J = X.shape
    T, D, K = temps.shape[0], inc_h.shape[1], route.shape[1]
    P, N = proc_params.shape[1], net_params.shape[1]
    variant, cpb = fused_anneal_variant(C, J, P, N, D, K)
    global_x = variant == "global"
    LAUNCH_SHAPES.add(("fused_anneal", C, J, P, N, D, K))
    scratch = torch.empty_like(bX) if global_x else None
    lib = _build.library("fused_anneal")
    _launch(lib.fused_anneal_launch, *(_ptr(t) for t in args), _ptr(bX),
            _ptr(stats),
            ctypes.c_void_p(scratch.data_ptr() if global_x else None),
            # global_x is a Python bool (the variant's name), not a tensor
            # tracelint: allow[CFN101]
            C, J, T, D, P, N, K, cpb, int(global_x))
