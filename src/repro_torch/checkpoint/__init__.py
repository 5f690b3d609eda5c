"""Asynchronous checkpoints with elastic re-sharding on restore (the
reference's ``checkpoint/``)."""
from .store import CheckpointStore
