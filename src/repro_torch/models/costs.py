"""Analytic parameter and per-layer cost accounting (the reference's
``models/costs.py``, the parts the CFN bridge reads).

``core.vsr.from_architecture`` turns per-layer GFLOP/token and inter-layer
activation bytes into the paper's VSR abstraction.  The counts come from
the real parameter tree: the reference traces ``init_model`` with
``jax.eval_shape``; the port builds its model on the ``meta`` device,
which allocates nothing.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import model as M
from .config import ArchConfig


def _meta_sizes(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    model = M.init_model(cfg, device="meta")
    return [(tuple(name.split(".")), p.numel())
            for name, p in model.named_parameters()]


def param_breakdown(cfg: ArchConfig) -> Dict[str, int]:
    """total / embedding / expert / active parameter counts."""
    sizes = _meta_sizes(cfg)
    total = sum(s for _, s in sizes)
    embed = sum(s for p, s in sizes if p[-1] in ("embed", "lm_head"))
    expert = sum(s for p, s in sizes if p[-1].startswith("we_"))
    active_expert = (expert * cfg.top_k / cfg.n_experts
                     if cfg.moe and cfg.n_experts else 0)
    active = total - expert + active_expert
    return dict(total=total, embed=embed, expert=expert,
                active=int(active), active_nonembed=int(active - embed),
                nonembed=total - embed)


def layer_costs(cfg: ArchConfig, context: int = 2048,
                ) -> Tuple[List[float], List[float]]:
    """(gflop_per_token per layer, boundary activation bytes per token).

    One transformer layer == one VM in the paper's abstraction.  Inference
    cost: 2 FLOPs per parameter plus the attention context term at the
    given context length.
    """
    model = M.init_model(cfg, device="meta")
    H, Dh = cfg.n_heads, cfg.head_dim
    gflops: List[float] = []
    act_bytes: List[float] = []
    for gi, grp in enumerate(M.layer_plan(cfg)):
        for unit in model.groups[gi]:
            for j, kind in enumerate(grp.kinds):
                n = sum(p.numel() for p in unit[f"b{j}"].parameters())
                w = M.block_window(cfg, kind)
                kv = min(w, context) if w else context
                gflops.append((2.0 * n + 4.0 * kv * H * Dh) / 1e9)
                act_bytes.append(2.0 * cfg.d_model)
    return gflops, act_bytes
