"""Logical-axis sharding on a torch ``DeviceMesh`` (the reference's
``parallel/``)."""
from . import sharding
