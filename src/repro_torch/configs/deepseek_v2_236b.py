"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434].

60L d_model=5120 128H vocab=102400; per-expert d_ff=1536; layer 0 dense
(public config: dense FFN 12288, see models.model._dense_ff).  MLA: q_lora
1536, kv_lora 512, qk_nope 128, qk_rope 64, v_head 128.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab=102_400,
    d_head=128,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    moe_group_tokens=512,
)
