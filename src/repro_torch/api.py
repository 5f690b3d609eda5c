"""Public placement API: ``from repro_torch.api import PlacementSpec,
CFNSession``.  Re-export of ``repro_torch.core.api``, with the online
engine's timelines and stats (``repro_torch.core.dynamic``); see
``chip_smoke.py`` at the repository root for a walkthrough on the card."""
from .core.api import CFNSession, PlacementSpec, SolveResult, solve_portfolio
from .core.api import __all__ as _core_all
from .core.dynamic import (SCENARIOS, ChurnScenario, OnlineEmbedder,
                           OnlineStats, ServiceEvent, WaveResult, churn_trace,
                           flash_crowd_trace, iter_waves, merge_timelines,
                           poisson_timeline, replay)

__all__ = list(_core_all) + [
    "OnlineEmbedder", "OnlineStats", "ServiceEvent", "ChurnScenario",
    "SCENARIOS", "WaveResult", "churn_trace", "flash_crowd_trace",
    "iter_waves", "merge_timelines", "poisson_timeline", "replay"]
