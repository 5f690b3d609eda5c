"""gemma2-27b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128.
Layer pattern (local, global) x 23; local window 4096; attn softcap 50,
final-logit softcap 30.  Global layers are full attention => long_500k skip.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256_000,
    d_head=128,
    local_global_period=2,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
)
