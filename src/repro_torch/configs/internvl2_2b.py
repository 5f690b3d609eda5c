"""internvl2-2b [vlm] — InternViT (stub) + InternLM2-1.8B backbone
[arXiv:2404.16821].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The vision tower is
a STUB: input_specs() supplies 256 precomputed patch embeddings per image,
prepended to the text tokens (the paper's "input VM pinned at the source" in
CFN terms).  Loss is computed on the text tail only.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    d_head=128,
    vision_prefix_tokens=256,
)
