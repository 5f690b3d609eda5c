"""Optimizer of the port: the reference's AdamW with global-norm clipping."""
from . import adamw
from .adamw import AdamWConfig, OptState, apply_updates, global_norm, schedule
