"""Public wrappers of the port's kernels.

On tensors that lie on a CUDA device each wrapper launches its CUDA kernel
(``kernels.placement_power``, ``kernels.flash_attention``), which raises if
it cannot run; on tensors on the CPU it runs the kernel's plain PyTorch
version.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.power import (PlacementAux, PlacementProblem, apply_pins,
                          as_placement, batched_hard_loads, to_tensor)
from . import flash_attention as fa
from . import placement_power as pp
from . import ref


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention in the TPU kernel's layout: q [B, H, Sq, D], k/v
    [B, KH, Skv, D] -> [B, H, Sq, D] in q's dtype.  Query i sits at
    position ``q_offset + i``, kv slot j at position j.  CPU tensors run
    the plain chunked version (``ref.flash_attention_ref``).  On CUDA
    tensors the call goes through ``flash_attention.attend``, so under grad
    the output has a ``grad_fn`` (the reference's chunked backward)."""
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       logit_cap=logit_cap, q_offset=q_offset)
    Sq, Skv = q.shape[2], k.shape[2]
    qpos = q_offset + torch.arange(Sq, dtype=torch.int32, device=q.device)
    kpos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return fa.attend(qt, kt, vt, qpos, kpos, causal=causal, window=window,
                     logit_cap=logit_cap).transpose(1, 2)


def placement_objective(problem: PlacementProblem, Xb) -> torch.Tensor:
    """Batched placement objective: Xb [B, R, V] -> [B, 4].

    Columns: (objective = power + penalty*violation, net W, proc W,
    violation).  Pins are applied first.
    """
    Xp = apply_pins(problem, Xb)
    Xflat = Xp.reshape(Xp.shape[0], -1).contiguous()
    fn = pp.placement_power_cuda if Xflat.is_cuda else pp.placement_power_ref
    return fn(Xflat, *pp.pack_problem(problem))


def fused_anneal(problem: PlacementProblem, aux: PlacementAux, Xc,
                 j_prop, p_prop, u_prop, temps,
                 eligible: Optional[torch.Tensor] = None):
    """Fused Metropolis annealing: whole chains in ONE kernel launch.

    Xc [C, R, V] int32 starting placements (pins applied by the caller);
    j_prop/p_prop/u_prop [C, T] proposals (flat free-VM index, destination
    node, uniform draw); temps [T]; aux = core.power.build_aux(problem).
    ``eligible`` [R, P] bool (optional) masks the proposal destinations onto
    each service row's eligible set (``mask_proposals``).  Returns
    (best_X [C, R, V], stats [C, 2] = (best obj, final obj)).  Initial loads
    come from one batched evaluation (``batched_hard_loads``).
    """
    dev = problem.device
    Xc = as_placement(problem, Xc)
    C, R, V = Xc.shape
    as_dev = lambda x, dt: to_tensor(x, dev, dt).contiguous()
    j_prop = as_dev(j_prop, torch.int32)
    p_prop = as_dev(p_prop, torch.int32)
    if eligible is not None:
        p_prop = pp.mask_proposals(j_prop, p_prop,
                                   to_tensor(eligible, dev), V)
    omega0, theta0, lam0, obj0 = batched_hard_loads(problem, Xc)
    _, _, F, _, route, proc_params, net_params = pp.pack_problem(problem)
    Xflat = Xc.reshape(C, -1).contiguous()
    fn = pp.fused_anneal_cuda if Xflat.is_cuda else pp.fused_anneal_ref
    bX, stats = fn(Xflat, j_prop, p_prop.contiguous(),
                   as_dev(u_prop, torch.float32), as_dev(temps, torch.float32),
                   *pp.pack_aux(aux), omega0.contiguous(), theta0.contiguous(),
                   lam0.contiguous(), obj0.contiguous(), F, route, proc_params,
                   net_params)
    return bX.reshape(C, R, V), stats
