"""Public placement API: ``from repro_torch.api import PlacementSpec,
CFNSession``.  Re-export of ``repro_torch.core.api`` (with
``SubstrateHealth``, the fault plane's substrate state, and the
multi-region ``FederatedSession`` / ``RegionPartition``), with the online
engine's timelines, fault presets and stats (``repro_torch.core.dynamic``);
see ``chip_smoke.py`` at the repository root for a walkthrough on the
card."""
from .core.api import (CFNSession, FederatedSession, PlacementSpec,
                       RegionPartition, SolveResult, SubstrateHealth,
                       solve_portfolio)
from .core.api import __all__ as _core_all
from .core.dynamic import (FAULT_SCENARIOS, SCENARIOS, ChurnScenario,
                           FaultEvent, OnlineEmbedder, OnlineStats,
                           ServiceEvent, WaveResult, churn_trace,
                           fault_preset, flash_crowd_trace, iter_waves,
                           merge_timelines, poisson_timeline, replay)

__all__ = list(_core_all) + [
    "OnlineEmbedder", "OnlineStats", "ServiceEvent", "FaultEvent",
    "ChurnScenario", "SCENARIOS", "FAULT_SCENARIOS", "WaveResult",
    "churn_trace", "fault_preset", "flash_crowd_trace", "iter_waves",
    "merge_timelines", "poisson_timeline", "replay"]
