"""The energy ledger: per-tick watts decomposed into the paper's Eq.(1)
networking vs Eq.(2) processing terms, integrated to joules over a
replay horizon.

Sampling model: the serving workload's power is PIECEWISE CONSTANT --
it changes only when a placement commits (churn, defrag, fault
re-embed), never between commits -- so sampling at commit time with
left-hold (step) integration is exact, and costs nothing: the committed
``SolveResult`` already carries the full ``PowerBreakdown``.

Dimensions:
  * total / net (Eq.1) / proc (Eq.2) watts -- every tick;
  * per-tier proc watts (iot/af/mf/cdc, from ``breakdown.per_proc``
    grouped by ``topo.proc_layer``) -- every tick once ``set_tiers``
    ran;
  * per-tenant watts (exact ``power.attribute_power`` split) and
    per-region watts (``federated_breakdown``) -- on the caller's
    cadence; held between samples.

Time units follow the caller's clock (churn timelines tick in hours,
so ``integrate()`` reports joules = W * 3600 * h when ``hours=True``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence


class EnergyLedger:
    def __init__(self, emit: Optional[Callable[..., Any]] = None) -> None:
        self.samples: List[dict] = []
        self.tiers: Optional[Dict[str, List[int]]] = None
        self._emit = emit

    def set_tiers(self, tiers: Dict[str, Sequence[int]]) -> None:
        """Processing-node tier map, e.g. ``{layer: node indices}`` built
        from ``topo.proc_layer`` (see ``tiers_of``)."""
        self.tiers = {k: list(v) for k, v in tiers.items()}

    def tick(self, t: float, total_w: float, net_w: float, proc_w: float,
             per_proc: Any = None,
             per_tenant: Optional[Dict[int, float]] = None,
             per_region: Optional[Dict[str, float]] = None,
             event: Optional[str] = None) -> dict:
        s: Dict[str, Any] = {"t": float(t), "total_w": float(total_w),
                             "net_w": float(net_w), "proc_w": float(proc_w)}
        if event is not None:
            s["event"] = event
        if per_proc is not None and self.tiers:
            s["tier_w"] = {layer: float(sum(float(per_proc[i]) for i in idx))
                           for layer, idx in self.tiers.items()}
        if per_tenant is not None:
            s["tenant_w"] = {str(k): float(v) for k, v in per_tenant.items()}
        if per_region is not None:
            s["region_w"] = {str(k): float(v) for k, v in per_region.items()}
        self.samples.append(s)
        if self._emit is not None:
            self._emit("energy", **s)
        return s

    def integrate(self, t_end: Optional[float] = None,
                  hours: bool = True) -> Dict[str, Any]:
        """Left-hold step integration of every recorded dimension.  The
        last sample extends to ``t_end`` (default: the last sample's
        time, i.e. it contributes nothing).  ``hours=True`` converts
        W*h to joules (x3600)."""
        if not self.samples:
            return {"joules_total": 0.0, "joules_net": 0.0,
                    "joules_proc": 0.0, "t_start": None, "t_end": None,
                    "samples": 0}
        ss = self.samples
        t1 = float(ss[-1]["t"]) if t_end is None else float(t_end)
        scale = 3600.0 if hours else 1.0
        tot = net = proc = 0.0
        by_tier: Dict[str, float] = {}
        by_tenant: Dict[str, float] = {}
        by_region: Dict[str, float] = {}
        held_tenant: Optional[Dict[str, float]] = None
        held_region: Optional[Dict[str, float]] = None
        for i, s in enumerate(ss):
            dt = (t1 if i + 1 == len(ss) else float(ss[i + 1]["t"])) \
                - float(s["t"])
            if dt < 0.0:
                dt = 0.0
            tot += s["total_w"] * dt
            net += s["net_w"] * dt
            proc += s["proc_w"] * dt
            for k, w in s.get("tier_w", {}).items():
                by_tier[k] = by_tier.get(k, 0.0) + w * dt
            held_tenant = s.get("tenant_w", held_tenant)
            if held_tenant:
                for k, w in held_tenant.items():
                    by_tenant[k] = by_tenant.get(k, 0.0) + w * dt
            held_region = s.get("region_w", held_region)
            if held_region:
                for k, w in held_region.items():
                    by_region[k] = by_region.get(k, 0.0) + w * dt
        out: Dict[str, Any] = {
            "joules_total": tot * scale, "joules_net": net * scale,
            "joules_proc": proc * scale,
            "t_start": float(ss[0]["t"]), "t_end": t1, "samples": len(ss)}
        if by_tier:
            out["joules_by_tier"] = {k: v * scale
                                     for k, v in by_tier.items()}
        if by_tenant:
            out["joules_by_tenant"] = {k: v * scale
                                       for k, v in by_tenant.items()}
        if by_region:
            out["joules_by_region"] = {k: v * scale
                                       for k, v in by_region.items()}
        return out


def tiers_of(topo: Any) -> Dict[str, List[int]]:
    """``{layer: processing-node indices}`` from ``topo.proc_layer``."""
    out: Dict[str, List[int]] = {}
    for i, layer in enumerate(topo.proc_layer):
        out.setdefault(layer, []).append(i)
    return out
