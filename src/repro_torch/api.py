"""Public placement API: ``from repro_torch.api import PlacementSpec,
CFNSession``.  Re-export of ``repro_torch.core.api``; see
``chip_smoke.py`` at the repository root for a walkthrough on the card."""
from .core.api import CFNSession, PlacementSpec, SolveResult, solve_portfolio
from .core.api import __all__ as _core_all

__all__ = list(_core_all)
