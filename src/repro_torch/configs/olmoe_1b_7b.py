"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) per-expert d_ff=1024 vocab=50304.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    qk_norm=True,
    moe=True,
    n_experts=64,
    n_shared_experts=0,
    top_k=8,
    moe_d_ff=1024,
    moe_group_tokens=512,
)
