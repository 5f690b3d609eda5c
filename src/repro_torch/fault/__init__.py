"""The fault plane: heartbeats, stragglers and the placement plane's
counters and availability integral (``monitor``), and the resilient
training runner (``runner``: checkpoints, restarts, elastic rescale)."""
from .monitor import HeartbeatMonitor, PlacementMonitor, StragglerTracker
from .runner import ResilientTrainer, RunReport, SimulatedFailure

__all__ = ["HeartbeatMonitor", "PlacementMonitor", "StragglerTracker",
           "ResilientTrainer", "RunReport", "SimulatedFailure"]
