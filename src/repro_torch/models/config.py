"""Unified architecture configuration for the 10 assigned architectures
(a copy of the reference's ``models/config.py``: plain dataclasses, no
framework).

One frozen dataclass covers dense GQA transformers, MLA, MoE, SWA /
local-global attention, logit softcaps, xLSTM (mLSTM+sLSTM), hybrid
attn-parallel-Mamba, encoder-decoder (whisper) and VLM-stub (internvl2).
Per-arch instances live in ``repro_torch.configs.<id>``; ``reduced`` gives
the small configuration the CPU tests run.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                   # 0 -> d_model // n_heads

    # attention flavour ----------------------------------------------------
    qk_norm: bool = False             # qwen3
    sliding_window: Optional[int] = None      # danube / hymba attention
    local_global_period: int = 0      # gemma2: every k-th layer is global
    attn_logit_softcap: Optional[float] = None   # gemma2 (50.0)
    final_logit_softcap: Optional[float] = None  # gemma2 (30.0)
    rope_theta: float = 10_000.0

    # MLA (deepseek-v2) ------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0               # 0 -> d_head

    # MoE --------------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0       # deepseek-v2: layer 0 is dense
    moe_group_tokens: int = 4096      # dispatch block size (memory knob)
    capacity_factor: float = 1.25

    # SSM / recurrent ----------------------------------------------------------
    block_pattern: Tuple[str, ...] = ()   # e.g. 7x'mlstm'+1x'slstm' per group
    ssm_state: int = 0                # mamba state dim (hymba)
    ssm_expand: int = 2               # mamba d_inner = expand * d_model
    conv_kernel: int = 4

    # encoder-decoder / multimodal ----------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    decoder_frac: float = 0.125       # dec_len = seq_len * frac (whisper train)
    vision_prefix_tokens: int = 0     # internvl2 stub patch embeddings

    # numerics -------------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat_policy: str = "full"        # full | dots | none
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def v_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def group_size(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and not any(
            b == "attn" for b in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token contexts (task: long_500k gate)?"""
        if self.family in ("ssm", "hybrid"):
            return True
        # pure SWA (every layer windowed) is sub-quadratic too (danube)
        return (self.sliding_window is not None
                and self.local_global_period == 0)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Static per-layer block kind, length n_layers."""
        if self.block_pattern:
            reps = math.ceil(self.n_layers / len(self.block_pattern))
            return tuple((self.block_pattern * reps)[: self.n_layers])
        return ("block",) * self.n_layers


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test reduction: same family/topology flags, tiny sizes."""
    base = dict(
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // max(1, cfg.n_heads))),
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        d_head=32,
    )
    if cfg.use_mla:
        base.update(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                    d_head=32, v_head_dim=32)
    if cfg.moe:
        base.update(n_experts=min(8, cfg.n_experts), top_k=min(2, cfg.top_k),
                    moe_d_ff=64, moe_group_tokens=64,
                    n_shared_experts=min(1, cfg.n_shared_experts),
                    first_dense_layers=min(1, cfg.first_dense_layers))
    if cfg.block_pattern:
        # keep the kind mix but shrink the group
        kinds = tuple(dict.fromkeys(cfg.block_pattern))
        pattern = kinds * (base["n_layers"] // len(kinds) or 1)
        base.update(block_pattern=pattern[: base["n_layers"]])
    if cfg.ssm_state:
        base.update(ssm_state=8)
    if cfg.is_encoder_decoder:
        base.update(encoder_layers=2)
    if cfg.vision_prefix_tokens:
        base.update(vision_prefix_tokens=8)
    if cfg.sliding_window:
        base.update(sliding_window=64)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
