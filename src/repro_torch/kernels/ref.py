"""Oracles for the port's kernels (tests assert vs these).

  * flash_attention_ref: the chunked online-softmax attention of the model
    path (``kernels.flash_attention.flash_attention``, the reference's
    ``layers.flash_attention``) in the TPU kernel's [B, H, S, D] layout.

Float64 numpy oracles for the placement kernels:

  * placement_objective_ref: the Eq.(1)+(2) objective from core.power,
    batched -- the float32 ground truth of the full-evaluation kernel.
  * placement_objective_f64 / placement_delta_ref: float64 numpy
    re-implementation of Eq.(1)+(2) on the padded-CSR route form (lambda
    accumulates each traffic-matrix entry along its route's <= K node ids).
    The delta oracle computes objective(X') - objective(X) at float64, where
    the subtraction is exact to ~1e-10 -- the yardstick for the delta engine
    (core.power.delta_move) and the fused annealing kernel.

They read a ``core.power.PlacementProblem`` wherever its tensors live.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.power import (ACTIVE_EPS, PENALTY, PlacementProblem, apply_pins,
                          evaluate_batch)
from .flash_attention import flash_attention


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        logit_cap: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q [B, H, Sq, D]; k/v [B, KH, Skv, D] -> [B, H, Sq, D] in q's dtype."""
    Sq, Skv = q.shape[2], k.shape[2]
    qpos = q_offset + torch.arange(Sq, dtype=torch.int32, device=q.device)
    kpos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        q_positions=qpos, kv_positions=kpos, causal=causal, window=window,
        logit_cap=logit_cap, kv_chunk=128)
    return out.transpose(1, 2).to(q.dtype)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def placement_objective_ref(problem: PlacementProblem,
                            Xb) -> torch.Tensor:
    """[B, R, V] placements -> [B, 4] (objective, net, proc, violation)."""
    bd = evaluate_batch(problem, Xb)
    return torch.stack([bd.objective, bd.net, bd.proc, bd.violation], -1)


def lam_f64_sparse(problem: PlacementProblem, tm: np.ndarray) -> np.ndarray:
    """lambda [N] from a traffic matrix [P, P] at float64, accumulated over
    the CSR route table."""
    p = problem
    rt = _np(p.route_idx)                                     # [P, P, K]
    K = rt.shape[2]
    buf = np.zeros(p.N + 1, np.float64)
    np.add.at(buf, rt.reshape(-1),
              np.repeat(np.asarray(tm, np.float64).reshape(-1), K))
    return buf[:p.N]


def eq_terms_f64(pp: dict, nn: dict, omega: np.ndarray, theta: np.ndarray,
                 lam: np.ndarray):
    """Per-node Eq.(1)/(2) terms at float64 -- the single f64 copy of the
    paper's power formulas.  ``pp``/``nn`` map the
    ``topology.proc_param_arrays`` / ``net_param_arrays`` keys to arrays;
    returns ``(per_net [N], per_proc [P], violation [])``.
    """
    g = lambda a: np.asarray(_np(a), np.float64)
    n_srv = np.ceil(omega / g(pp["C_pr"]))
    beta = (lam > ACTIVE_EPS).astype(np.float64)
    phi = ((omega > ACTIVE_EPS) | (theta > ACTIVE_EPS)).astype(np.float64)
    per_net = g(nn["pue_net"]) * (g(nn["eps"]) * lam / 1e3
                                  + beta * g(nn["idle_share"])
                                  * g(nn["pi_net"]))
    per_proc = g(pp["pue_pr"]) * (g(pp["E"]) * omega + n_srv * g(pp["pi_pr"])
                                  + g(pp["EL"]) * theta / 1e3
                                  + phi * g(pp["lan_share"])
                                  * g(pp["pi_lan"]))
    relu = lambda x: np.maximum(x, 0.0)
    violation = (relu(omega - g(pp["NS"]) * g(pp["C_pr"])).sum()
                 + relu(lam / 1e3 - g(nn["C_net"])).sum()
                 + relu(theta / 1e3 - g(pp["C_lan"])).sum())
    return per_net, per_proc, float(violation)


_PP_KEYS = ("E", "C_pr", "NS", "pi_pr", "pue_pr", "EL", "C_lan", "pi_lan",
            "lan_share")
_NN_KEYS = ("eps", "C_net", "pi_net", "pue_net", "idle_share")


def placement_objective_f64(problem: PlacementProblem, X) -> float:
    """Eq.(1)+(2) objective of one placement at float64 (numpy)."""
    p = problem
    P = p.P
    X = _np(apply_pins(p, X))
    onehot = np.eye(P, dtype=np.float64)[X]                   # [R, V, P]
    F = _np(p.F).astype(np.float64)
    h = _np(p.link_h).astype(np.float64)
    flat = onehot.reshape(-1, P)
    u = flat[_np(p.link_src)]                                 # [L, P]
    w = flat[_np(p.link_dst)]
    omega = np.einsum("rvp,rv->p", onehot, F)
    tm = np.einsum("l,lp,lq->pq", h, u, w)
    intra = np.einsum("l,lp,lp->p", h, u, w)
    lam = lam_f64_sparse(p, tm)
    theta = (u.T @ h) + (w.T @ h) - intra
    per_net, per_proc, violation = eq_terms_f64(
        {k: getattr(p, k) for k in _PP_KEYS},
        {k: getattr(p, k) for k in _NN_KEYS}, omega, theta, lam)
    return float(per_net.sum() + per_proc.sum() + PENALTY * violation)


def placement_objective_f64_links(problem: PlacementProblem, X) -> float:
    """``placement_objective_f64`` accumulated link by link on the
    problem's host arrays (``PlacementProblem.host``): each virtual link's
    bitrate added at its two end nodes and along its route's <= K network
    nodes.  The same float64 function without the [L, P] one-hots and the
    [P, P] traffic matrix, so it evaluates a merged federated substrate
    (P = 1864) in well under a second and reads no device tensor but the
    per-node parameters."""
    p, h = problem, problem.host
    X = np.where(h.fixed_mask, h.fixed_node, _np(X)).reshape(-1)
    omega = np.bincount(X, np.asarray(h.F, np.float64).reshape(-1),
                        minlength=p.P)
    a, b = X[h.link_src], X[h.link_dst]
    hh = np.asarray(h.link_h, np.float64)
    theta = (np.bincount(a, hh, minlength=p.P)
             + np.bincount(b, hh * (a != b), minlength=p.P))
    ids = h.route_idx[a, b]                                   # [L, K]
    lam = np.bincount(ids.reshape(-1), np.repeat(hh, ids.shape[1]),
                      minlength=p.N + 1)[:p.N]
    per_net, per_proc, violation = eq_terms_f64(
        {k: getattr(p, k) for k in _PP_KEYS},
        {k: getattr(p, k) for k in _NN_KEYS}, omega, theta, lam)
    return float(per_net.sum() + per_proc.sum() + PENALTY * violation)


def placement_delta_ref(problem: PlacementProblem, X, r: int, v: int,
                        p_new: int) -> float:
    """Float64 oracle for a single-VM move: objective(X') - objective(X)."""
    X = _np(X)
    X2 = X.copy()
    X2[r, v] = p_new
    return (placement_objective_f64(problem, X2)
            - placement_objective_f64(problem, X))
