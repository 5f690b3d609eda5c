"""Analytic parameter and per-layer cost accounting (the reference's
``models/costs.py``, the parts the CFN bridge reads).

``core.vsr.from_architecture`` turns per-layer GFLOP/token and inter-layer
activation bytes into the paper's VSR abstraction.  The counts come from
parameter shapes: the reference traces ``init_model`` with
``jax.eval_shape``; the port makes the same shapes on the ``meta`` device,
which allocates nothing.  ``layer_costs`` needs only each block's shapes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import layers as L
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


def _block_sizes(cfg: ArchConfig, kind: str) -> Tuple[int, int]:
    """(parameters, of which expert weights) of one block of ``kind``, from
    the shapes ``init_block`` makes, on the meta device (whisper's
    ``dec_attn`` with its cross-attention projections)."""
    ini = L.Init(None, torch.device("meta"), torch.float32)
    M.init_block(ini, cfg, kind)
    total = sum(t.numel() for t in ini.params.values())
    expert = sum(t.numel() for name, t in ini.params.items()
                 if name.startswith("we_"))
    return total, expert


def layer_costs(cfg: ArchConfig, context: int = 2048,
                ) -> Tuple[List[float], List[float]]:
    """(gflop_per_token per layer, boundary activation bytes per token).

    One decoder layer == one VM in the paper's abstraction (an
    encoder-decoder's encoder layers are not counted, as in the
    reference).  Inference
    cost: 2 FLOPs per active parameter (a MoE block's experts count
    top_k / n_experts) plus, for every kind that attends (not mLSTM or
    sLSTM), the attention context term at the given context length.
    """
    H, Dh = cfg.n_heads, cfg.head_dim
    gflops: List[float] = []
    act_bytes: List[float] = []
    for grp in M.layer_plan(cfg):
        sizes = {kind: _block_sizes(cfg, kind) for kind in grp.kinds}
        for _ in range(grp.repeats):
            for kind in grp.kinds:
                n, expert = sizes[kind]
                if cfg.moe and kind in ("attn_moe", "mla_moe"):
                    n = n - expert + expert * cfg.top_k / cfg.n_experts
                fl = 2.0 * n
                if kind not in M.SSM_KINDS:
                    w = M.block_window(cfg, kind)
                    kv = min(w, context) if w else context
                    fl += 4.0 * kv * H * Dh
                gflops.append(fl / 1e9)
                act_bytes.append(2.0 * cfg.d_model)
    return gflops, act_bytes
