"""The telemetry plane threaded through the port's engine, sessions and
federation, against the JAX package's, on the CPU (the template is
``tests/test_telemetry.py``).

Under the deterministic specs both packages place identically (the
engine's coordinate spec of ``tests/test_torch_online.py``, the
federation's "quick" spec of ``tests/test_torch_federation.py``), so their
telemetry must agree too: span names and parents equal, the solve events'
event / method / n_live / t equal and their objective and power rtol 1e-5,
ledger joules and per-tier watts rtol 1e-5, the per-tenant split rtol 1e-5
and summing to the total, the federated ledger's regions plus
``inter_region`` equal to the total to 1e-9 x total, and the counted
solver entries' fresh-shape deltas (``TRACE_COUNTS``) equal to the
reference's jit traces.  With telemetry disabled placements are
byte-equal to an instrumented run's."""
import jax
import numpy as np
import pytest

from repro.api import (CFNSession as JSession, FederatedSession as JFed,
                       PlacementSpec as JSpec)
from repro.core import dynamic as jdyn, solvers as js, topology as jtopo, \
    vsr as jvsr
from repro.fault.monitor import PlacementMonitor as JMonitor
from repro.telemetry import Telemetry as JTel
from repro_torch.api import (CFNSession, FederatedSession as TFed,
                             PlacementSpec as TSpec)
from repro_torch.core import dynamic as tdyn, federation as tfed, \
    power as tp, solvers as ts, topology as ttopo, vsr as tvsr
from repro_torch.fault import PlacementMonitor as TMonitor
from repro_torch.kernels import ref as tref
from repro_torch.telemetry import Telemetry, tiers_of, validate_events

CPU = "cpu"
CITY = dict(n_olt=2, onus_per_olt=4, iot_per_onu=8)
CITY_SOURCES = [0, 9, 17, 40]
DET = dict(method="coordinate", anneal_steps=0, defrag_every=0)
FED = dict(n_regions=3, n_olt=1, onus_per_olt=2, iot_per_onu=2, n_core=6)
QUICK = dict(effort="quick", anneal_steps=0, defrag_every=0)
RTOL = 1e-5


@pytest.fixture(scope="module")
def paper():
    return jtopo.paper_topology(), ttopo.paper_topology()


@pytest.fixture(scope="module")
def city():
    return ttopo.city_scale(**CITY)


def _svc(pkg, seed, sources=(0,), n_vms=3):
    return pkg.random_vsrs(1, rng=np.random.default_rng(seed),
                           n_vms=n_vms, source_nodes=list(sources))


def _churn(sess, pkg=tvsr, sources=(0,)):
    """A small churn sequence on a session: 3 adds, 1 remove, 1 wave."""
    for seed in (0, 1, 2):
        sess.engine.tick(float(seed))
        sess.add(_svc(pkg, seed, sources))
    sess.engine.tick(3.0)
    sess.remove(sess.sids[0])
    sess.engine.tick(4.0)
    sess.apply_wave([(_svc(pkg, 7, sources), None, 0),
                     (_svc(pkg, 8, sources), None, 0)], [sess.sids[0]])
    return sess


def _fresh(before):
    return {k: v - before.get(k, 0) for k, v in ts.TRACE_COUNTS.items()
            if v != before.get(k, 0)}


# ---------------------------------------------------------------------------
# disabled path: a no-op by construction
# ---------------------------------------------------------------------------

def test_disabled_telemetry_is_identical(city, tmp_path):
    """telemetry=None vs a live Telemetry on one churn scenario and one
    generator seed (every re-solve's anneal draws from it): the
    same placements byte for byte, admissions and power, and the second,
    instrumented run sees no fresh shape fingerprint."""
    spec = TSpec(method="coordinate", anneal_steps=100)
    plain = _churn(CFNSession(city, spec, device=CPU), sources=CITY_SOURCES)
    before = dict(ts.TRACE_COUNTS)
    tel = Telemetry(jsonl_path=str(tmp_path / "run.jsonl"),
                    attribution_every=2)
    instr = _churn(CFNSession(city, spec, device=CPU, telemetry=tel),
                   sources=CITY_SOURCES)
    assert not _fresh(before)
    assert plain.sids == instr.sids and plain.admission == instr.admission
    assert plain.X.tobytes() == instr.X.tobytes()
    assert plain.power_w() == instr.power_w()
    assert [s.objective for s in plain.stats] == \
        [s.objective for s in instr.stats]
    oracle = tref.placement_objective_f64(instr.problem, instr.X)
    assert instr.objective() == pytest.approx(oracle, rel=RTOL)
    rep = tel.report()
    assert rep["compiles"]["agree"] and rep["launches"]["agree"]
    assert len(tel.ledger.samples) == len(instr.stats)
    tel.close()


# ---------------------------------------------------------------------------
# the engine end to end against the reference
# ---------------------------------------------------------------------------

def _det_run(dyn, Spec, topo, vsrm, tel, **kw):
    """bootstrap -> add -> remove -> defrag, a churn_trace replay, then a
    wave, with the deterministic spec and ``tel`` attached."""
    eng = dyn.OnlineEmbedder(topo, spec=Spec(**DET), telemetry=tel, **kw)
    sv = lambda n, s0: [vsrm.random_vsrs(1, rng=s0 + i, source_nodes=[0])
                        for i in range(n)]
    eng.bootstrap(sv(4, 100))
    eng.tick(1.0)
    eng.add(sv(1, 900)[0])
    eng.tick(2.0)
    eng.remove(eng.sids[1])
    eng.tick(3.0)
    eng.defrag()
    eng.tick(4.0)
    dyn.replay(eng, dyn.churn_trace(6, 6, rng=2)[6:],
               lambda sid: vsrm.random_vsrs(1, rng=800 + sid,
                                            source_nodes=[0]))
    eng.apply_wave([(sv(1, 950)[0], None, 0), (sv(1, 951)[0], None, 0)],
                   [eng.sids[0]])
    return eng


def test_engine_telemetry_matches_jax(paper):
    """The deterministic engine run on both packages, telemetry attached
    with the per-tenant split every commit: span names and parents equal,
    solve events equal (objective and power rtol 1e-5), ledger joules and
    per-tier watts rtol 1e-5, the tenant split rtol 1e-5 and summing to
    the total, and the fresh-shape deltas of the counted entries equal to
    the reference's jit traces (both caches cleared first)."""
    jt, tt = paper
    jtel, ttel = JTel(attribution_every=1), Telemetry(attribution_every=1)
    jax.clear_caches()
    jbefore = dict(js.TRACE_COUNTS)
    jeng = _det_run(jdyn, JSpec, jt, jvsr, jtel)
    jfresh = {k: v - jbefore.get(k, 0) for k, v in js.TRACE_COUNTS.items()
              if v != jbefore.get(k, 0)}
    ts.clear_trace_cache()
    tbefore = dict(ts.TRACE_COUNTS)
    teng = _det_run(tdyn, TSpec, tt, tvsr, ttel, device=CPU)
    assert _fresh(tbefore) == jfresh and jfresh["sweep"] > 0
    assert teng.sids == jeng.sids

    def spans(tel):
        evs = [e for e in tel.events if e["type"] == "span"]
        by_id = {e["id"]: e["name"] for e in evs}
        return [(e["name"], by_id.get(e["parent"]),
                 {k: v for k, v in (e["attrs"] or {}).items()
                  if k != "objective"}) for e in evs]

    assert spans(ttel) == spans(jtel)
    assert ("resolve_wave", "apply_wave") in [s[:2] for s in spans(ttel)]
    wave = lambda tel: next(e["attrs"]["objective"] for e in tel.events
                            if e["type"] == "span"
                            and e["name"] == "resolve_wave")
    assert wave(ttel) == pytest.approx(wave(jtel), rel=RTOL)

    solves = lambda tel: [e for e in tel.events if e["type"] == "solve"]
    assert len(solves(ttel)) == len(solves(jtel)) == len(teng.stats)
    for got, want in zip(solves(ttel), solves(jtel)):
        for k in ("event", "method", "n_live", "t", "engine"):
            assert got[k] == want[k], k
        for k in ("objective", "power_w"):
            assert got[k] == pytest.approx(want[k], rel=RTOL), k

    gi, wi = ttel.ledger.integrate(), jtel.ledger.integrate()
    for k in ("joules_total", "joules_net", "joules_proc"):
        assert gi[k] == pytest.approx(wi[k], rel=RTOL), k
    for dim in ("joules_by_tier", "joules_by_tenant"):
        assert set(gi[dim]) == set(wi[dim])
        for k, v in wi[dim].items():
            assert gi[dim][k] == pytest.approx(v, rel=RTOL, abs=1e-3), \
                (dim, k)
    for got, want in zip(ttel.ledger.samples, jtel.ledger.samples):
        assert set(got["tier_w"]) == set(tiers_of(tt))
        for k, v in want["tier_w"].items():
            assert got["tier_w"][k] == pytest.approx(v, rel=RTOL, abs=1e-6)
        assert set(got["tenant_w"]) == set(want["tenant_w"])
        for k, v in want["tenant_w"].items():
            assert got["tenant_w"][k] == pytest.approx(v, rel=RTOL,
                                                       abs=1e-6), k
        assert sum(got["tenant_w"].values()) == pytest.approx(
            got["total_w"], rel=1e-6)
        assert sum(got["tier_w"].values()) == pytest.approx(
            got["proc_w"], rel=1e-6)
    # the last split is the engine's own attribution
    per = teng.per_service_power_w()
    last = ttel.ledger.samples[-1]["tenant_w"]
    assert last == {str(s): pytest.approx(w, rel=1e-9)
                    for s, w in per.items()}
    rep = ttel.report()
    assert rep["compiles"]["agree"] and rep["launches"]["agree"]


def test_session_monitor_mirrors_into_telemetry(paper):
    """A session's monitor attached beside its telemetry mirrors its
    counts there, as the reference's does, through a fault handler."""
    jt, tt = paper
    jtel, ttel = JTel(), Telemetry()
    jmon, tmon = JMonitor(), TMonitor()
    js_ = JSession(jt, JSpec(**DET), monitor=jmon, telemetry=jtel)
    ts_ = CFNSession(tt, TSpec(**DET), device=CPU)
    ts_.attach_telemetry(ttel)
    ts_.attach_monitor(tmon)
    assert ts_.telemetry is ttel and tmon.telemetry is ttel
    for s, pkg in ((js_, jvsr), (ts_, tvsr)):
        s.solve(pkg.random_vsrs(4, rng=3, source_nodes=[0, 3, 5]))
        s.apply_fault(tdyn.FaultEvent(1.0, "fail_node", int(s.X[0, 1]))
                      if s is ts_ else
                      jdyn.FaultEvent(1.0, "fail_node", int(s.X[0, 1])))
    np.testing.assert_array_equal(ts_.X, np.asarray(js_.X))
    mon = lambda tel: {k: v for k, v in tel.counters.items()
                       if k.startswith("monitor.")}
    assert mon(ttel) == mon(jtel) and mon(ttel)
    kinds = lambda tel: [e["kind"] for e in tel.events
                         if e["type"] == "event"]
    assert kinds(ttel) == kinds(jtel)
    names = lambda tel: [e["name"] for e in tel.events if e["type"] == "span"]
    assert names(ttel) == names(jtel) == ["bootstrap", "apply_fault"]


# ---------------------------------------------------------------------------
# convergence traces
# ---------------------------------------------------------------------------

def test_convergence_trace_fixed_length(paper):
    """``record_conv`` gives the reference's fixed length, a monotone best
    objective and acceptance rates in [0, 1]; off, no trace and no fresh
    shape."""
    jt, tt = paper
    vs = tvsr.random_vsrs(4, rng=0, n_vms=3)
    prob = tp.build_problem(tt, vs, device=CPU)
    jprob = __import__("repro.core.power", fromlist=["x"]).build_problem(
        jt, jvsr.random_vsrs(4, rng=0, n_vms=3))
    X0 = np.zeros((prob.R, prob.V), np.int32)
    res = ts.anneal(prob, ts.default_generator(0), X0, n_steps=64,
                    backend="delta", record_conv=True)
    jres = js.anneal(jprob, jax.random.PRNGKey(0), X0, n_steps=64,
                     backend="delta", record_conv=True)
    assert set(res.conv) == set(jres.conv) == {"best_obj", "accept_rate"}
    for k in res.conv:
        assert len(res.conv[k]) == len(jres.conv[k]) == 64
    assert (np.diff(np.asarray(res.conv["best_obj"])) <= 1e-6).all()
    ar = np.asarray(res.conv["accept_rate"])
    assert (ar >= 0).all() and (ar <= 1).all()
    before = dict(ts.TRACE_COUNTS)
    res2 = ts.anneal(prob, ts.default_generator(0), X0, n_steps=64,
                     backend="delta")
    assert res2.conv is None and not _fresh(before)
    assert res2.X.tobytes() == res.X.tobytes()


def test_commit_records_convergence(paper):
    """An instrumented session's incremental commits carry the convergence
    trace, of the reference's length per effort bucket, downsampled to at
    most 64 points in the solve event."""
    jt, tt = paper
    jtel, ttel = JTel(), Telemetry()
    kw = dict(method="coordinate", anneal_steps=200)
    jsess = JSession(jt, JSpec(**kw), telemetry=jtel)
    tsess = CFNSession(tt, TSpec(**kw), device=CPU, telemetry=ttel)
    for s, pkg in ((jsess, jvsr), (tsess, tvsr)):
        s.add(_svc(pkg, 0))
        s.add(_svc(pkg, 1))
    assert {k: len(v) for k, v in tsess.result.conv.items()} == \
        {k: len(v) for k, v in jsess.result.conv.items()}
    conv = lambda tel: [{k: len(v) for k, v in e["conv"].items()}
                        for e in tel.events
                        if e["type"] == "solve" and "conv" in e]
    assert conv(ttel) and conv(ttel) == conv(jtel)
    assert all(n <= 64 for c in conv(ttel) for n in c.values())
    assert ttel.hists["solve.accept_rate_final"].count == len(conv(ttel))


# ---------------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------------

def test_federated_ledger_regions_sum_exact():
    """The coordinator's fleet-exact ledger: on the reference's fixture
    and the deterministic spec, every sample's regions plus
    ``inter_region`` equal its total (1e-9 x total), its net plus proc
    too, each equal to the reference's sample, and the last one to the
    session's exact breakdown; the coordinator's spans are the
    reference's."""
    jtopo_, ttopo_ = (jtopo.federated_scale(**FED),
                      ttopo.federated_scale(**FED))
    part = tfed.RegionPartition.from_topology(ttopo_)
    srcs = [int(r.proc_ids[0]) for r in part.regions]
    jtel, ttel = JTel(), Telemetry()
    jsess = JFed(jtopo_, JSpec(**QUICK), key=jax.random.PRNGKey(3),
                 telemetry=jtel)
    tsess = TFed(ttopo_, TSpec(**QUICK), device=CPU, telemetry=ttel)
    for s, pkg in ((jsess, jvsr), (tsess, tvsr)):
        s.solve(pkg.random_vsrs(6, rng=1, n_vms=3, source_nodes=srcs))
        s.tick(1.0)
        s.add(pkg.random_vsrs(1, rng=9, n_vms=3, source_nodes=[srcs[1]]))
        s.tick(2.0)
        s.remove(s.sids[0])
    np.testing.assert_array_equal(tsess.X, np.asarray(jsess.X))
    assert len(ttel.ledger.samples) == len(jtel.ledger.samples) == 3
    for got, want in zip(ttel.ledger.samples, jtel.ledger.samples):
        tot = got["total_w"]
        assert abs(sum(got["region_w"].values()) - tot) <= 1e-9 * tot
        assert abs(got["net_w"] + got["proc_w"] - tot) <= 1e-9 * tot
        assert got["event"] == want["event"] and got["t"] == want["t"]
        assert tot == pytest.approx(want["total_w"], rel=1e-12)
        assert set(got["region_w"]) == set(want["region_w"])
        for k, v in want["region_w"].items():
            assert got["region_w"][k] == pytest.approx(v, rel=1e-12,
                                                       abs=1e-9)
    bd = tsess.breakdown()
    last = ttel.ledger.samples[-1]
    assert last["total_w"] == pytest.approx(bd.total_w, rel=1e-12)
    assert last["region_w"]["inter_region"] == pytest.approx(
        bd.inter_region_w, rel=1e-12, abs=1e-9)
    names = lambda tel: [e["name"] for e in tel.events if e["type"] == "span"]
    assert names(ttel) == names(jtel) == ["federated_solve", "federated_add",
                                          "federated_remove"]
    assert ttel.counters["commit.federated_add"] == 1
    assert validate_events(ttel.events) == []


def test_single_region_federation_delegates_telemetry(paper):
    """A one-region federation hands its telemetry to the flat session:
    the engine's spans and commits, no coordinator span."""
    _, tt = paper
    tel = Telemetry()
    sess = TFed(tt, TSpec(**QUICK), device=CPU, telemetry=tel)
    assert sess._flat is not None and sess._flat.telemetry is tel
    sess.solve(tvsr.random_vsrs(3, rng=4, source_nodes=[0]))
    sess.add(tvsr.random_vsrs(1, rng=5, source_nodes=[0]))
    names = [e["name"] for e in tel.events if e["type"] == "span"]
    assert names == ["bootstrap", "add"]
    assert len(tel.ledger.samples) == 2
    sess.attach_telemetry(None)
    assert sess._flat.telemetry is None
