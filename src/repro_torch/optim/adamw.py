"""AdamW with global-norm clipping (the reference's ``optim/adamw.py``).

The optimizer state mirrors the parameters (m, v in float32, one tensor a
leaf) beside a step ``count``.  ``apply_updates`` keeps the reference's
arithmetic -- the clip scale, bias corrections with ``count`` in float32,
``p - lr * (u + wd * p)`` -- and updates parameters and moments in place
under ``torch.no_grad``, so no second copy of the moments is made.  Not
``torch.optim.AdamW``: its bias correction and decay differ.

Weight decay follows the reference's rule, ``p.ndim >= 2`` on the
reference's shapes.  Its layer leaves carry a stacked ``repeats`` axis, so
every leaf of a layer group is decayed, norm scales included; only
top-level 1-D leaves are exempt.  Callers whose leaves are unstacked (the
port's per-layer modules) pass that mask as ``decay``
(``train.step.decay_mask``).

Sharded state (``train.step``'s sharded step) passes each rank's blocks:
the update is elementwise, and ``global_norm`` sums the blocks' squares
over the process group, each leaf's weighted by 1 / its replica count, so
every element counts once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    count: torch.Tensor                       # int32 scalar


def state_axes(param_axes):
    """Logical axes for the optimizer state (mirrors params)."""
    return OptState(m=param_axes, v=param_axes, count=())


def init(params: Sequence[torch.Tensor]) -> OptState:
    """Zero moments in float32 beside each parameter, count 0 (on the
    parameters' device)."""
    params = list(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = params[0].device if params else None
    return OptState(m=[zeros(p) for p in params],
                    v=[zeros(p) for p in params],
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (float32)."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(torch.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors: Sequence[torch.Tensor],
                replicas: Optional[Sequence[int]] = None,
                groups: Sequence = ()) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.
    Sharded leaves: ``tensors`` are this rank's blocks, ``replicas[i]`` the
    number of ranks holding leaf i's block; the weighted sums are added
    over each process group of ``groups`` in turn (a mesh's axes; none:
    the default group), so each element counts once."""
    sq = [x.float().square().sum() for x in tensors]
    if replicas is None:
        return torch.sqrt(torch.stack(sq).sum())
    import torch.distributed as dist
    total = torch.stack([s / r for s, r in zip(sq, replicas)]).sum()
    for group in groups or (None,):
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor], state: OptState,
                  cfg: AdamWConfig, decay: Optional[Sequence[bool]] = None,
                  replicas: Optional[Sequence[int]] = None,
                  groups: Sequence = ()
                  ) -> Tuple[OptState, Dict[str, torch.Tensor]]:
    """One AdamW step over parallel lists of parameters and gradients, in
    place (parameters, m, v).  ``decay[i]``: whether leaf i takes weight
    decay (default: ``p.ndim >= 2``, the reference's rule on the shapes
    given).  ``replicas`` / ``groups``: the lists are a rank's blocks of
    sharded leaves (``global_norm``).  Returns the state with
    ``count + 1`` and metrics ``grad_norm`` and ``lr`` (0-d tensors)."""
    params, grads = list(params), list(grads)
    if decay is None:
        decay = [p.ndim >= 2 for p in params]
    gnorm = global_norm(grads, replicas, groups)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    for p, g, m, v, wd in zip(params, grads, state.m, state.v, decay):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        u = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        if wd:
            u.add_(cfg.weight_decay * p.float())
        p.sub_((lr * u).to(p.dtype))
    return OptState(m=state.m, v=state.v, count=count), dict(
        grad_norm=gnorm, lr=lr)
