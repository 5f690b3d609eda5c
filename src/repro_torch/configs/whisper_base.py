"""whisper-base [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model=512 8H d_ff=2048 vocab=51865.  The
conv/mel frontend is a STUB: input_specs() supplies precomputed frame
embeddings [B, S_enc, d_model]; decoder length = seq_len * decoder_frac.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    is_encoder_decoder=True,
    encoder_layers=6,
    decoder_frac=0.125,
    tie_embeddings=True,
)
