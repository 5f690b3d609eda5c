"""CFN108 runtime contract of the port: static shape bounds vs measured
fresh shapes.

``repro_torch.analysis.compute_cache_bounds`` claims a static bound on the
shape-fingerprint key-space of every ``@count_traces`` entry (the JAX
package's jit-cache bound, in the port's terms: ``solvers.count_traces``
ticks once per fresh abstract shape fingerprint).  These tests check the
claim three ways: the port's static bounds against the JAX package's over
its own source; real scenarios on the port on the CPU, for each exercised
entry

    measured <= bound(scenario) <= 2 * measured

(sound: never undercounts; tight: within 2x); and
``Telemetry.report(bounds=)`` against the JAX package's on one paper-scale
churn scenario.  Scenario bounds come from ``EntryBound.evaluate`` with the
realized axis cardinalities; unexercised call sites are excluded by
context.

Shape hygiene: each scenario uses a service shape (``n_vms``) no other
port test uses, and clears the port's fingerprint cache first, so the
measured deltas are true fresh-shape counts.
"""
from pathlib import Path

import numpy as np
import pytest

import repro.analysis as ref_analysis
from repro_torch.analysis import CACHE_CAPS, compute_cache_bounds
from repro_torch.analysis.engine import load_project
from repro_torch.api import FederatedSession, PlacementSpec
from repro_torch.core import federation, power, solvers, topology, vsr

REPO = Path(__file__).resolve().parents[1]
ENTRIES = ("sweep", "anneal_delta", "anneal_full", "solve_regions")


@pytest.fixture(scope="module")
def bounds():
    project, errs = load_project([str(REPO / "src" / "repro_torch")])
    assert not errs
    return compute_cache_bounds(project)


@pytest.fixture(scope="module")
def ref_bounds():
    project, errs = ref_analysis.load_project([str(REPO / "src" / "repro")])
    assert not errs
    return ref_analysis.compute_cache_bounds(project)


def _deltas(before):
    return {k: solvers.TRACE_COUNTS.get(k, 0) - before.get(k, 0)
            for k in set(solvers.TRACE_COUNTS) | set(before)}


def _check(entry, measured, bound):
    assert bound is not None, f"{entry}: scenario bound is unbounded"
    assert measured <= bound, \
        f"{entry}: measured {measured} fresh shapes > static bound {bound}"
    assert bound <= 2 * measured, \
        f"{entry}: static bound {bound} not within 2x of measured {measured}"


def test_static_bounds_equal_the_reference_but_one_pinned_site(
        bounds, ref_bounds):
    """Each entry's static bound equals the JAX package's over its own
    source, but ``anneal_delta``: the port has one more call site, the
    region loop ``federation._solve_regions_loop`` (the plain version the
    tests hold the vmapped lockstep ``_solve_regions`` to), at one
    fingerprint family -- 11 against 10.  ``sweep`` is equal (26): the
    port's lockstep vmaps the uncounted ``_sweep_step``, the loop's
    ``_sweep`` site takes its place."""
    got = {e: bounds[e].static_bound() for e in ENTRIES}
    want = {e: ref_bounds[e].static_bound() for e in ENTRIES}
    assert want == {"sweep": 26, "anneal_delta": 10, "anneal_full": 1,
                    "solve_regions": 24}
    assert got == {**want, "anneal_delta": want["anneal_delta"] + 1}
    loop = [s for s in bounds["anneal_delta"].sites
            if s.context == "_solve_regions_loop"]
    assert len(loop) == 1 and all(a.kind == "param" for a in loop[0].axes)
    for e in ENTRIES:
        assert got[e] <= CACHE_CAPS[e]
    # the batched solve's axes come back through _batch_inputs: its
    # bucketed degree and the effort tier, as the reference's
    kinds = sorted((a.kind, a.card)
                   for a in bounds["solve_regions"].axes().values()
                   if a.kind != "param")
    assert kinds == [("bucket", None), ("finite", 3)]


def _paper_problem(n_vsrs, n_vms, rng):
    topo = topology.paper_topology()
    vs = vsr.random_vsrs(n_vsrs, rng=rng, n_vms=n_vms,
                         source_nodes=topo.layer_indices("iot")[:3])
    problem = power.build_problem(topo, vs, device="cpu")
    X0 = solvers.fixed_layer(problem, topo, "iot").X
    return topo, vs, problem, power.init_state(problem, X0)


def test_churn_wave_traces_within_static_bounds(bounds):
    """A two-bucket churn trace through ``resolve_wave``: the realized
    ``sweep`` / ``anneal_delta`` fresh shapes sit inside the CFN108
    scenario bounds of the ``resolve_incremental`` call sites."""
    # n_vms=5 is unique to this test among the port's
    _, _, problem, state = _paper_problem(6, 5, 0)
    kw = dict(anneal_steps=50, anneal_chains=4)
    waves = [[0], [1, 2, 3]]            # two distinct wave-shape buckets
    fixed = problem.host.fixed_mask
    realized = {solvers._pow2(int((~fixed[rows]).sum())) for rows in waves}
    assert len(realized) == 2, "scenario must span two buckets"

    solvers.clear_trace_cache()
    before = dict(solvers.TRACE_COUNTS)
    for rows in waves:
        solvers.resolve_wave(problem, state, rows,
                             gen=solvers.default_generator(0), **kw)
    d = _deltas(before)

    cards = {"resolve_incremental.pad_changed_to": len(realized),
             # polish pads to one fixed all-free-VM list per problem shape
             "resolve_incremental.pad_positions_to": 1}
    for entry in ("sweep", "anneal_delta"):
        bound = bounds[entry].evaluate(sites=["resolve_incremental"],
                                       axis_cards=cards)
        _check(entry, d.get(entry, 0), bound)
    # the Metropolis run's proposals are flat VM indices [T, C], the same
    # shape in both buckets: one anneal_delta fingerprint against the
    # bound's 2 (within 2x)
    assert d["sweep"] == 3 and d["anneal_delta"] == 1


def test_federated_solve_regions_within_static_bound(bounds):
    """Two same-bucket federated solves take one ``solve_regions`` shape;
    the CFN108 scenario bound of the ``solve_portfolio_batched`` site (one
    substrate bucket, one effort tier) agrees within 2x.  The port holds
    no ``sweep`` count here: its lockstep sweeps vmap the uncounted
    ``_sweep_step``, where the JAX package traces ``sweep`` once inside
    its jitted ``solve_regions`` (``test_torch_telemetry``'s
    ``test_federated_trace_counts_against_jax``)."""
    topo = topology.federated_scale(n_regions=3, n_olt=1, onus_per_olt=2,
                                    iot_per_onu=2, n_core=6)
    part = federation.RegionPartition.from_topology(topo)
    srcs = [int(r.proc_ids[0]) for r in part.regions]
    # n_vms=7 is unique to this test among the port's
    vs1 = vsr.random_vsrs(6, rng=0, n_vms=7, source_nodes=srcs)
    vs2 = vsr.random_vsrs(6, rng=5, n_vms=7, source_nodes=srcs)
    vs2.src[:] = vs1.src                # same homes -> same shape bucket
    spec = PlacementSpec(effort="quick")

    solvers.clear_trace_cache()
    before = dict(solvers.TRACE_COUNTS)
    FederatedSession(topo, spec, device="cpu").solve(vs1)
    FederatedSession(topo, spec, device="cpu").solve(vs2)
    d = _deltas(before)

    eb = bounds["solve_regions"]
    cards = {name: 1 for name, ax in eb.axes().items()
             if ax.kind in ("bucket", "finite")}   # one bucket, one effort
    bound = eb.evaluate(sites=["solve_portfolio_batched"], axis_cards=cards)
    _check("solve_regions", d.get("solve_regions", 0), bound)
    assert d.get("solve_regions") == 1 and d.get("sweep", 0) == 0


def test_telemetry_report_bounds_equal_the_reference(bounds, ref_bounds):
    """The port's ``Telemetry.report(bounds=)`` on a paper-scale churn
    wave: the attribution hook records exactly the fresh shapes
    ``TRACE_COUNTS`` ticks, every recorded entry is within its static
    bound, and ``compiles["bounds"]`` equals the JAX package's on the
    same scenario -- the same entries, ``within`` and ``static_bound``,
    but ``anneal_delta``'s, one higher (the pinned site above)."""
    import jax
    from repro.core import power as jpower, solvers as jsolvers, \
        topology as jtopo, vsr as jvsr
    from repro.telemetry import Telemetry as JTelemetry
    from repro_torch.telemetry import Telemetry

    kw = dict(anneal_steps=50, anneal_chains=4)
    # n_vms=8 is unique to this test among the port's
    topo, vs, problem, state = _paper_problem(5, 8, 2)
    tel = Telemetry()
    tel.attach_traces()
    solvers.clear_trace_cache()
    before = dict(solvers.TRACE_COUNTS)
    solvers.resolve_wave(problem, state, [0, 1],
                         gen=solvers.default_generator(0), **kw)
    measured = {k: v for k, v in _deltas(before).items() if v}
    rep = tel.report(bounds=bounds)
    tel.close()
    assert rep["compiles"]["agree"] is True
    assert rep["compiles"]["recorded"] == measured
    assert set(measured) == {"sweep", "anneal_delta"}
    got = rep["compiles"]["bounds"]
    assert all(chk["within"] for chk in got.values())

    jt = jtopo.paper_topology()
    jvs = jvsr.random_vsrs(5, rng=2, n_vms=8,
                           source_nodes=jt.layer_indices("iot")[:3])
    assert np.array_equal(jvs.F, vs.F) and np.array_equal(jvs.src, vs.src)
    jprob = jpower.build_problem(jt, jvs)
    jX0 = np.asarray(jsolvers.fixed_layer(jprob, jt, "iot").X, np.int32)
    jstate = jpower.init_state(jprob, jX0)
    jtel = JTelemetry()
    jtel.attach_traces()
    jax.clear_caches()
    jsolvers.resolve_wave(jprob, jstate, [0, 1], key=jax.random.PRNGKey(0),
                          **kw)
    want = jtel.report(bounds=ref_bounds)["compiles"]["bounds"]
    jtel.close()
    assert set(got) == set(want)
    for entry in got:
        assert got[entry]["within"] == want[entry]["within"] is True
        pin = 1 if entry == "anneal_delta" else 0
        assert got[entry]["static_bound"] \
            == want[entry]["static_bound"] + pin
