"""The fault plane's monitors: heartbeats, stragglers and the placement
plane's counters and availability integral."""
from .monitor import HeartbeatMonitor, PlacementMonitor, StragglerTracker

__all__ = ["HeartbeatMonitor", "PlacementMonitor", "StragglerTracker"]
