"""Flow-sensitive tracelint rules of the port (CFN106-CFN109) over
``dataflow``.

These are ``ProjectRule``s: one shared dataflow run per analysis
(``dataflow.analyze_dataflow``, memoized on the Project) feeds all four
families, and findings land on whichever module/line they belong to.

  CFN106  random-stream discipline -- a draw on the global stream (no
          ``generator=``), and a generator re-seeded inside a loop with
          a seed no iteration changes.
  CFN107  launch aliasing -- an output buffer of a kernel launch (the
          ctypes launchers' output slots, ``dataflow.LAUNCH_OUTPUTS``;
          the Python in-place consumers, ``INPLACE_CONSUMERS``) that is
          also one of that launch's inputs.
  CFN108  shape-cardinality -- the statically bounded key-space of the
          shape fingerprints of every ``@count_traces`` entry (the
          JAX package's bound algebra and caps); unbounded provenance
          reaching an entry, or a bound above its cap, is a finding.
          ``compute_cache_bounds`` is the API the runtime contract test
          and ``Telemetry.report(bounds=)`` read.
  CFN109  dead device compute -- tensors from ``torch.*``, tensor
          methods, ``.to(...)`` or ``torch.as_tensor`` (and host copies
          through ``np.asarray``) assigned and never read.

Findings carry NO line numbers in their messages: the baseline
fingerprint is ``rule::context::message`` and must survive both line
shifts and a function moving across files.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import Finding, Project, ProjectRule
from .dataflow import CacheAxis, EntryCall, analyze_dataflow

# ---------------------------------------------------------------------------
# CFN106: random-stream discipline
# ---------------------------------------------------------------------------


class PrngKeyDiscipline(ProjectRule):
    """Every random draw owns its stream.

    The JAX package's invariant -- every draw consumes a key nothing else
    consumes -- reads in torch as: draw from a ``torch.Generator`` the
    caller controls (``generator=``), never from the global stream that
    any other caller (a library, another test) advances; and never
    re-seed a generator inside a loop from a seed no iteration changes
    (every iteration replays the same stream, the JAX package's loop
    fan-out without a split)."""

    id = "CFN106"
    title = "random-stream discipline"

    def check_project(self, project: Project) -> Iterable[Finding]:
        an = analyze_dataflow(project)
        for key in sorted(an.functions):
            facts = an.functions[key]
            mod = project.by_path.get(facts.path)
            if mod is None:
                continue
            for line, draw in facts.global_draws:
                yield self.finding(
                    mod, line,
                    f"`{draw}` draws from the global random stream (pass "
                    "generator= so the draw owns its stream)")
            for line, call, _loop in facts.reseeds:
                yield self.finding(
                    mod, line,
                    f"`{call}` re-seeds inside a loop with a seed no "
                    "iteration changes (every iteration replays the same "
                    "stream)")


# ---------------------------------------------------------------------------
# CFN107: launch aliasing
# ---------------------------------------------------------------------------

class DonationDiscipline(ProjectRule):
    """A kernel launch writes its output buffers while it reads its
    inputs: handing one tensor to both slots of one launch makes the
    result depend on the order the kernel's threads happen to run in
    (the JAX package's donated buffer aliasing a live input).  Scope: the
    ctypes launchers of ``csrc/*.cu`` (their output slots in
    ``dataflow.LAUNCH_OUTPUTS``) and the Python functions that launch
    into buffers their caller passes (``dataflow.INPLACE_CONSUMERS``);
    buffers through plain names, ``_ptr(t)``, ``p(t)``,
    ``c_void_p(t.data_ptr())`` and a local tuple of them."""

    id = "CFN107"
    title = "launch aliasing"

    def check_project(self, project: Project) -> Iterable[Finding]:
        an = analyze_dataflow(project)
        for key in sorted(an.functions):
            facts = an.functions[key]
            mod = project.by_path.get(facts.path)
            if mod is None:
                continue
            seen: Set[Tuple] = set()
            for ev in facts.alias_events:
                k = (ev.var, ev.launch, ev.line)
                if k in seen:
                    continue
                seen.add(k)
                yield self.finding(
                    mod, ev.line,
                    f"`{ev.var}` is both an output and an input of "
                    f"`{ev.launch}` (the launch writes a buffer it reads)")


# ---------------------------------------------------------------------------
# CFN108: shape-cardinality
# ---------------------------------------------------------------------------

# Declared per-entry caps: how many distinct shape fingerprints the
# bucket discipline may produce for each @count_traces entry at the
# documented deployment scale (the JAX package's caps).  The runtime
# contract test (tests/test_torch_cache_contract.py) cross-checks the
# static bound against measured TRACE_COUNTS.
CACHE_CAPS: Dict[str, int] = {
    "sweep": 64,
    "anneal_delta": 64,
    "anneal_full": 32,
    "solve_regions": 32,
}
DEFAULT_CACHE_CAP = 64

# default axis cardinalities for the STATIC bound: a pow-2 bucket axis
# can realize at most ~log2(R*V) distinct buckets at the documented max
# scale; a param axis is one fingerprint per caller-supplied shape family.
STATIC_BUCKET_CARD = 8
STATIC_PARAM_CARD = 1


@dataclasses.dataclass
class EntryBound:
    """Static fingerprint key-space of one ``@count_traces`` entry.

    ``sites`` are its project-wide call sites; each carries the cache
    axes (provenance roots) of the values reaching the entry there.
    The bound is the sum over call sites of the product of axis
    cardinalities -- ``evaluate`` lets a runtime scenario substitute
    realized cardinalities (and drop unexercised sites) to compare
    against measured TRACE_COUNTS."""

    entry: str
    sites: List[EntryCall] = dataclasses.field(default_factory=list)

    def axes(self) -> Dict[str, CacheAxis]:
        out: Dict[str, CacheAxis] = {}
        for s in self.sites:
            for ax in s.axes:
                out.setdefault(ax.name, ax)
        return out

    @staticmethod
    def _card(ax: CacheAxis, axis_cards: Optional[Dict[str, int]],
              default_bucket: int, default_param: int) -> Optional[int]:
        if axis_cards and ax.name in axis_cards:
            return axis_cards[ax.name]
        if ax.kind == "finite":
            return ax.card
        if ax.kind == "param":
            return default_param
        if ax.kind == "bucket":
            return default_bucket
        if ax.kind == "unbounded":
            return None
        return 1

    def evaluate(self, sites: Optional[Sequence[str]] = None,
                 axis_cards: Optional[Dict[str, int]] = None,
                 default_bucket: int = 1,
                 default_param: int = 1) -> Optional[int]:
        """Bound under a scenario: ``sites`` restricts to call sites in
        the named enclosing functions (None = all); ``axis_cards`` maps
        axis names to realized cardinalities.  Returns None when an
        included axis is statically unbounded and not overridden."""
        total = 0
        for s in self.sites:
            if sites is not None and s.context not in sites:
                continue
            prod = 1
            for ax in s.axes:
                c = self._card(ax, axis_cards, default_bucket,
                               default_param)
                if c is None:
                    return None
                prod *= max(int(c), 1)
            total += prod
        return total

    def static_bound(self) -> Optional[int]:
        return self.evaluate(default_bucket=STATIC_BUCKET_CARD,
                             default_param=STATIC_PARAM_CARD)


def compute_cache_bounds(project: Project) -> Dict[str, EntryBound]:
    """Per-entry static shape-fingerprint bounds over the whole project
    (the CFN108 substrate and the contract-test API)."""
    an = analyze_dataflow(project)
    out: Dict[str, EntryBound] = {
        name: EntryBound(name) for name in an.index.entry_defs}
    for c in an.entry_calls:
        out.setdefault(c.entry, EntryBound(c.entry)).sites.append(c)
    for eb in out.values():
        eb.sites.sort(key=lambda s: (s.path, s.line))
    return out


class CacheCardinality(ProjectRule):
    """Every ``@count_traces`` entry must have a statically BOUNDED
    shape-fingerprint key-space under the declared caps: a value of
    unbounded provenance (I/O, wall clock, an unresolved call with no
    rooted inputs) reaching an entry's arguments means every new value
    is a fresh shape -- a new fingerprint, a new set of cached views
    and, once the sweeps are captured in CUDA graphs, a new capture."""

    id = "CFN108"
    title = "shape-cardinality"

    def check_project(self, project: Project) -> Iterable[Finding]:
        bounds = compute_cache_bounds(project)
        an = analyze_dataflow(project)
        for entry in sorted(bounds):
            eb = bounds[entry]
            unbounded = False
            for site in eb.sites:
                mod = project.by_path.get(site.path)
                if mod is None:
                    continue
                for ax in site.axes:
                    if ax.kind != "unbounded":
                        continue
                    unbounded = True
                    root = ax.name.split("@")[0]
                    slot = "a scalar-keyed slot" if ax.static \
                        else "a shape-determining slot"
                    yield self.finding(
                        mod, site.line,
                        f"entry `{entry}`: value of statically unbounded "
                        f"provenance ({root}) reaches {slot} of the "
                        "counted call -- its shape-fingerprint key-space "
                        "is unbounded (every new value is a fresh shape)")
            if unbounded:
                continue
            b = eb.static_bound()
            cap = CACHE_CAPS.get(entry, DEFAULT_CACHE_CAP)
            if b is not None and b > cap:
                ed = an.index.entry_defs.get(entry)
                if ed is None:
                    continue
                yield self.finding(
                    ed.mod, ed.fn.lineno,
                    f"entry `{entry}`: static shape bound {b} exceeds "
                    f"the declared cap {cap} (tighten the shape bucketing "
                    "or raise CACHE_CAPS with justification)")


# ---------------------------------------------------------------------------
# CFN109: dead device compute
# ---------------------------------------------------------------------------

class DeadDeviceCompute(ProjectRule):
    """A tensor-producing call assigned to a name that is never read is
    wasted device work -- and for ``.cpu()`` / ``.numpy()`` /
    ``np.asarray`` of a device value, a dead device-to-host copy that
    syncs the stream (the JAX package's PR 7 bug class).  Names prefixed
    ``_`` are exempt (the documented discard idiom)."""

    id = "CFN109"
    title = "dead device compute"

    def check_project(self, project: Project) -> Iterable[Finding]:
        an = analyze_dataflow(project)
        for key in sorted(an.functions):
            facts = an.functions[key]
            mod = project.by_path.get(facts.path)
            if mod is None:
                continue
            for line, name, call in sorted(facts.dead_assigns):
                yield self.finding(
                    mod, line,
                    f"tensor `{name}` ({call}) is computed but never "
                    "consumed (dead compute / dead transfer; delete it "
                    f"or rename to `_{name}`)")


def flow_rules() -> List[ProjectRule]:
    return [PrngKeyDiscipline(), DonationDiscipline(), CacheCardinality(),
            DeadDeviceCompute()]
