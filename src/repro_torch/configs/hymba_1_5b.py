"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16 vocab=32001.
Every layer fuses an attention branch and a mamba branch on the same input
(mean-combined).  Window 1024 on most layers; one global layer per 16
(the published model uses 3 global layers at first/middle/last -- we use the
periodic approximation 0 and 16, recorded in DESIGN.md).  Hybrid with O(1)
SSM state + windowed attention => long_500k runs.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    d_head=64,
    sliding_window=1024,
    local_global_period=16,
    ssm_state=16,
    ssm_expand=2,
    conv_kernel=4,
)
