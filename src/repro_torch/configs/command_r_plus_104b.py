"""command-r-plus-104b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, head_dim=128.
Pure full attention => long_500k skip.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256_000,
    d_head=128,
)
