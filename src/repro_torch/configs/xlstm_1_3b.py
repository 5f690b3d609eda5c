"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H d_ff=0 vocab=50304.  Block pattern 7:1 mLSTM:sLSTM (the
paper's 1.3B ratio); ssm_expand=1 calibrates to the published ~1.3B total
(DESIGN.md dimensional note).  Attention-free => long_500k runs (O(1) state).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm_expand=1,
    conv_kernel=4,
    tie_embeddings=False,
)
