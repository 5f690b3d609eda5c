"""Analytic parameter / FLOP accounting (the reference's ``models/costs.py``).

Two consumers:
  * the dry run (``launch/dryrun.py``): ``model_flops`` -- 6 N D a train
    step, 2 N D a prefill, 2 N a decoded token (N = active non-embedding
    parameters), plus the attention context terms of ``attention_flops``
    -- is the useful work a step's counted products are held against;
  * the CFN bridge (``core.vsr.from_architecture``): per-layer GFLOP/token
    and inter-layer activation bytes turn an architecture into the paper's
    VSR abstraction.

The counts come from
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


def _attention_layers(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """(kind, effective kv dim) for every layer that attends."""
    return [(kind, cfg.head_dim) for grp in M.layer_plan(cfg)
            for _ in range(grp.repeats) for kind in grp.kinds
            if kind not in M.SSM_KINDS]


def attention_flops(cfg: ArchConfig, s_q: int, s_kv: int,
                    causal_avg: bool) -> float:
    """Scores + PV flops for the whole stack at the given context."""
    total = 0.0
    H, Dh = cfg.n_heads, cfg.head_dim
    for kind, _ in _attention_layers(cfg):
        w = M.block_window(cfg, kind)
        kv = min(w, s_kv) if w else s_kv
        if causal_avg and kv == s_kv:
            kv = max(1, kv // 2)
        total += 4.0 * s_q * kv * H * Dh
    return total


def model_flops(cfg: ArchConfig, shape) -> Dict[str, float]:
    """Useful FLOPs for one step of ``shape`` (a ``configs.Shape``) over
    the whole mesh, with the parameter counts they come from."""
    from ..launch.specs import dec_len     # launch imports models
    pb = param_breakdown(cfg)
    N = pb["active_nonembed"]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        toks = B * dec_len(cfg, S)
        flops = 6.0 * N * toks + 3.0 * attention_flops(
            cfg, dec_len(cfg, S), dec_len(cfg, S), causal_avg=True) * B
    elif shape.kind == "prefill":
        toks = B * dec_len(cfg, S)
        flops = 2.0 * N * toks + attention_flops(
            cfg, dec_len(cfg, S), dec_len(cfg, S), causal_avg=True) * B
    else:  # decode: one token against an S-token cache
        flops = 2.0 * N * B + attention_flops(cfg, 1, S,
                                              causal_avg=False) * B
    return dict(total_flops=flops, params=pb)


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
