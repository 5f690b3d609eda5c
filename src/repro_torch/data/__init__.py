"""Training data of the port: the reference's deterministic synthetic-token
stream (numpy only)."""
from .pipeline import DataConfig, DataIterator, make_batch, synth_tokens
