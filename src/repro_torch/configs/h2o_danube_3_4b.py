"""h2o-danube-3-4b [dense] — llama+mistral mix with SWA [arXiv:2401.16818].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000; sliding window 4096
on every layer => sub-quadratic decode, long_500k runs with a ring-buffer KV
cache of 4096 slots.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    d_head=120,
    sliding_window=4096,
)
