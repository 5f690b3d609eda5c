"""The fault plane of the PyTorch port against the JAX package, on the CPU
(the template is ``tests/test_faults.py``, its flat cases).

``SubstrateHealth`` (degrade, eligibility, ``PlacementSpec.masks``), the
fail / recover handlers, ``apply_fault``, fault events in both replay
modes, the fault presets and the monitors.  Every engine case feeds a JAX
``CFNSession`` and a port ``CFNSession(device="cpu")``, each with its own
``PlacementMonitor``, the same calls on ``city_scale(2, 2, 2)`` under the
reference test's deterministic spec (cfn-milp "quick", no anneal, no
periodic defrag).  After every call they must agree on placements (equal),
objectives (rtol 1e-5 / atol 5e-2), sids, ``queued_sids``, ``admission``,
the stats' events, the health masks and the monitors' counters, open
strand windows and stranded-service integral.  Degraded problems equal the
reference's; presets and timelines are byte-equal.  A fault re-solve with
the anneal on the reference's own random streams lands within 5e-2 of the
reference's objective.

Two reference cases have no counterpart: the pytree half of the spec case
(the port has no pytree) and the retrace count (the port compiles
nothing), which the padded position-list lengths replace."""
import jax
import numpy as np
import pytest
from _hyp import given, settings, st

from repro.api import PlacementSpec as JSpec, SubstrateHealth as JHealth
from repro.core import dynamic as jdyn, power as jp, solvers as js, \
    topology as jtopo, vsr as jvsr
from repro.fault import monitor as jmon
from repro_torch.api import PlacementSpec as TSpec, SubstrateHealth as THealth
from repro_torch.core import dynamic as tdyn, power as tp, \
    solvers as ts, topology as ttopo, vsr as tvsr
from repro_torch.fault import monitor as tmon
from repro_torch.kernels import ref as tref
from test_torch_online import _ref_streams, _targets
from test_torch_waves import OBJ_TOL, Twin, _events, _svcs

CPU = "cpu"
CITY = dict(n_olt=2, onus_per_olt=2, iot_per_onu=2)
QUICK = dict(effort="quick", anneal_steps=0, defrag_every=0)


@pytest.fixture(scope="module")
def city():
    return jtopo.city_scale(**CITY), ttopo.city_scale(**CITY)


class FTwin(Twin):
    """A ``Twin`` whose sessions each report to a ``PlacementMonitor``;
    ``do`` drives both sessions and holds them equal after the call."""

    def __init__(self, topos, spec_kw):
        super().__init__(topos, spec_kw)
        self.jm, self.tm = jmon.PlacementMonitor(), tmon.PlacementMonitor()
        self.j.attach_monitor(self.jm)
        self.t.attach_monitor(self.tm)

    def do(self, name, *args):
        jr, tr = (getattr(self.j, name)(*args), getattr(self.t, name)(*args))
        if jr is None or not hasattr(jr, "method"):
            assert tr is None or not hasattr(tr, "method")
        else:
            assert tr.method == jr.method
            np.testing.assert_allclose(tr.objective, jr.objective, **OBJ_TOL)
        self.check()
        return tr

    def check(self):
        super().check()
        j, t = self.j, self.t
        if j.health is None:
            assert t.health is None
        else:
            np.testing.assert_array_equal(t.health.node_up, j.health.node_up)
            np.testing.assert_array_equal(t.health.link_up, j.health.link_up)
        assert self.tm.counters == self.jm.counters
        assert self.tm.events == self.jm.events
        assert self.tm.stranded_since == self.jm.stranded_since
        assert self.tm.stranded_service_s == pytest.approx(
            self.jm.stranded_service_s, abs=1e-12)
        if t.problem is not None:
            np.testing.assert_array_equal(t.problem.NS.numpy(),
                                          np.asarray(j.problem.NS))
            np.testing.assert_array_equal(t.problem.C_net.numpy(),
                                          np.asarray(j.problem.C_net))


def _ftwin(topos, n=5, seed0=0, **spec_kw):
    """A twin with n live services (sids 0..n-1, services by seed)."""
    tw = FTwin(topos, dict(QUICK, **spec_kw))
    for i in range(n):
        jr, tr = tw.add(seed0 + i, i)
        assert jr is not None and tr is not None
    tw.check()
    return tw


def _hosting_non_source(tw):
    """A node hosting at least one live VM that is no service's source."""
    eng = tw.t.engine
    srcs = {int(sv.src[0]) for sv in eng._vsrs}
    for r in range(eng.n_live):
        for x in eng.X[r, :eng._vsrs[r].V]:
            if int(x) not in srcs:
                return int(x)
    return None


def _oracle_gap(session):
    oracle = tref.placement_objective_f64(session.problem, session.X)
    return abs(oracle - session.objective()), oracle


def _chain(svcs):
    b = svcs[0]
    for sv in svcs[1:]:
        b = b.concat(sv)
    return b


def _problems(topos, n, **kw):
    jt, tt = topos
    return (jp.build_problem(jt, _chain(_svcs(jvsr, jt, n)), **kw),
            tp.build_problem(tt, _chain(_svcs(tvsr, tt, n)), device=CPU,
                             **kw))


def _healths(topos, fails):
    """The same health in both packages: ``fails`` is a list of
    ("node" | "link", id)."""
    jt, tt = topos
    jh, th = JHealth.fresh(jt), THealth.fresh(tt)
    for kind, i in fails:
        jh = getattr(jh, f"fail_{kind}")(i)
        th = getattr(th, f"fail_{kind}")(i)
    return jh, th


# ---------------------------------------------------------------------------
# SubstrateHealth: degrade + eligibility + spec masks
# ---------------------------------------------------------------------------

def test_health_degrade_shapes_and_values(city):
    """Value-only degradation equal to the reference's, into new tensors:
    the healthy problem is untouched, its host copies carry over, and the
    per-node pack is rebuilt."""
    jprob, tprob = _problems(city, 3)
    h = THealth.fresh(city[1])
    assert h.all_up
    assert h.degrade(tprob) is tprob        # all-up: identity, no copies
    NS0 = tprob.NS.clone()
    _ = tprob.proc_pack                      # cached on the healthy problem
    jh2, h2 = _healths(city, [("node", 3), ("link", 5)])
    assert not h2.all_up and h.all_up       # immutable updates
    d = h2.degrade(tprob)
    jd = jh2.degrade(jprob)
    for name in ("NS", "C_lan", "C_net", "C_pr", "E", "pi_pr"):
        assert getattr(d, name).shape == getattr(tprob, name).shape
        np.testing.assert_array_equal(getattr(d, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    assert float(d.NS[3]) == 0.0 and float(d.C_lan[3]) == 0.0
    assert float(d.C_net[5]) == 0.0
    assert float(d.C_pr[3]) == float(tprob.C_pr[3])
    assert d.route_idx is tprob.route_idx
    assert d.host is tprob.host
    assert bool((tprob.NS == NS0).all())     # never written in place
    np.testing.assert_array_equal(d.proc_pack[6].numpy(),
                                  (d.NS * d.C_pr).numpy())
    X = np.random.default_rng(0).integers(0, tprob.P, (tprob.R, tprob.V))
    np.testing.assert_allclose(float(tp.objective(d, X)),
                               float(jp.objective(jd, X)), rtol=1e-5)
    np.testing.assert_allclose(float(tp.objective(d, X)),
                               tref.placement_objective_f64(d, X),
                               rtol=1e-5, atol=5e-2)
    assert h2.recover_node(3).recover_link(5).all_up


@pytest.mark.parametrize("fails", [[("node", 2)], [("link", 0)],
                                   [("link", 7)],
                                   [("node", 9), ("link", 3), ("link", 11)]],
                         ids=["node", "link0", "link7", "mixed"])
def test_health_eligibility_masks_dead_elements(city, fails):
    """eligibility, pair_alive and route_ok equal to the reference's; a
    dead node is ineligible everywhere, and a row's eligibility is the
    liveness of the routes from its source."""
    jprob, tprob = _problems(city, 3)
    jh, th = _healths(city, fails)
    el = th.eligibility(tprob)
    assert el.shape == (tprob.R, tprob.P)
    np.testing.assert_array_equal(el, jh.eligibility(jprob))
    np.testing.assert_array_equal(th.pair_alive(tprob), jh.pair_alive(jprob))
    np.testing.assert_array_equal(th.route_ok(), jh.route_ok())
    for kind, i in fails:
        if kind == "node":
            assert not el[:, i].any()
    src0 = int(tprob.host.fixed_node[0, 0])
    assert (el[0] == th.pair_alive(tprob)[src0] & th.node_up).all()


@pytest.mark.parametrize("max_hops", [None, 3])
def test_spec_health_masks(city, max_hops):
    """PlacementSpec(health=...) masks as the reference's, hop bound
    included; an all-up health is no constraint (``None``)."""
    jt, tt = city
    jprob, tprob = _problems(city, 2, pad_to_rows=4)
    spec = TSpec(**QUICK, health=THealth.fresh(tt))
    assert spec.masks(tprob) is None         # all-up: unconstrained
    for fails in ([("node", 1)], [("node", 1), ("link", 4)]):
        jh, th = _healths(city, fails)
        tspec = TSpec(**QUICK, max_hops=max_hops, health=th)
        jspec = JSpec(**QUICK, max_hops=max_hops, health=jh)
        el = tspec.masks(tprob)
        assert el is not None and not el[:, 1].any()
        np.testing.assert_array_equal(el, jspec.masks(jprob))


# ---------------------------------------------------------------------------
# the closed loop: fail -> re-embed -> recover on the online engine
# ---------------------------------------------------------------------------

@settings(deadline=None, max_examples=4)
@given(seed=st.integers(0, 10_000))
def test_fail_recover_roundtrip_matches_oracle(seed):
    """fail_node of a hosting node moves every VM off it, the degraded
    commit is the float64 oracle's, recovery and a defrag bring every
    service back oracle-exact -- and the JAX package agrees after every
    call."""
    tw = _ftwin((jtopo.city_scale(**CITY), ttopo.city_scale(**CITY)),
                seed0=seed % 100)
    node = _hosting_non_source(tw)
    if node is None:
        return
    tw.do("tick", 1.0)
    assert tw.do("fail_node", node) is not None
    X = tw.t.X
    for r in range(tw.t.n_live):
        assert node not in X[r, :tw.t.engine._vsrs[r].V]
    gap, oracle = _oracle_gap(tw.t)
    assert gap <= 1e-3 + 1e-5 * abs(oracle)
    tw.do("tick", 2.0)
    tw.do("recover_node", node)
    assert tw.t.health.all_up
    tw.do("defrag")
    assert tw.t.n_live == 5
    gap, oracle = _oracle_gap(tw.t)
    assert gap <= 1e-3 + 1e-5 * abs(oracle)
    assert float(tw.t.result.breakdown.violation) <= 1e-6


@settings(deadline=None, max_examples=4)
@given(seed=st.integers(0, 10_000))
def test_stranded_never_silently_dropped(seed):
    """Failing a source strands every service sourced there (parked, one
    open window each); recovery re-admits them all and closes every
    window, with the stranded time integrated -- as the reference."""
    tw = _ftwin((jtopo.city_scale(**CITY), ttopo.city_scale(**CITY)),
                seed0=seed % 100)
    admitted = set(tw.t.sids)
    svcs = tw.t.engine._vsrs
    src = int(svcs[0].src[0])
    hit = {sid for sid, sv in zip(tw.t.sids, svcs) if int(sv.src[0]) == src}
    tw.do("tick", 1.0)
    tw.do("fail_node", src)
    queued = set(tw.t.engine.queued_sids)
    assert set(tw.t.sids) | queued == admitted
    assert hit <= queued
    assert tw.tm["service_stranded"] == len(queued)
    assert tw.tm.stranded_since.keys() == queued
    tw.do("tick", 4.0)
    tw.do("recover_node", src)
    assert set(tw.t.sids) == admitted
    assert not tw.t.engine._queue
    assert not tw.tm.stranded_since
    assert tw.tm.stranded_service_s >= 3.0 * len(hit) - 1e-9
    assert tw.tm["re_embedded"] >= len(hit)


def test_fail_recover_bucket_lengths(city, monkeypatch):
    """The reference counts retraces across same-bucket fail / recover
    cycles (none after the first); the port compiles nothing, so it holds
    the sweeps' position lists instead: the second cycle sweeps the same
    lengths as the first, every polish over R x (V - 1) positions."""
    tw = _ftwin(city)
    node = _hosting_non_source(tw)
    assert node is not None
    lengths = []
    sweep = ts._sweep
    monkeypatch.setattr(ts, "_sweep", lambda p, a, s, pos, el=None: (
        lengths.append(len(pos)), sweep(p, a, s, pos, el))[1])
    cycles = []
    for _ in range(2):
        del lengths[:]
        tw.do("fail_node", node)
        tw.do("recover_node", node)
        cycles.append(list(lengths))
    p = tw.t.problem
    assert cycles[0] == cycles[1]
    assert cycles[0].count(p.R * (p.V - 1)) >= 4    # two polishes a re-solve


def test_link_failure_reroutes_traffic(city):
    tw = _ftwin(city)
    lam = tw.t.engine._state.lam.numpy()
    n = int(np.argmax(lam))
    np.testing.assert_array_equal(n, int(np.argmax(np.asarray(
        tw.j.engine._state.lam))))
    assert lam[n] > 0
    tw.do("tick", 1.0)
    tw.do("fail_link", n)
    assert tw.tm["link_failed"] == 1
    if tw.t.n_live:
        assert float(tw.t.engine._state.lam[n]) <= 1e-2
    assert set(tw.t.sids) | set(tw.t.engine.queued_sids) == set(range(5))
    tw.do("recover_link", n)
    assert tw.t.health.all_up and tw.tm["link_recovered"] == 1


def test_brownout_tightens_admission_and_restores(city):
    tw = _ftwin(city, n=2)
    tw.do("tick", 1.0)
    tw.do("brownout", 0.0)
    jr, tr = tw.add(77, 50)
    assert jr is None and tr is None
    tw.check()
    assert tw.t.n_live == 2 and tw.tm["brownout"] == 1
    assert tw.tm["admission_rejected"] == 1
    assert tw.tm["power_budget_exceeded"] == 1
    tw.do("tick", 2.0)
    tw.do("brownout_end")
    assert tw.t.spec.power_budget_w is None
    assert tw.tm["brownout_end"] == 1


def test_untouched_fault_only_rescores(city, monkeypatch):
    """A dead node that hosts nothing: method "untouched", no re-solve,
    the same placement scored on the degraded problem; its recovery
    re-settles with one re-solve and no displaced rows."""
    tw = _ftwin(city)
    used = set(np.unique(tw.t.X)) | {int(s.src[0])
                                     for s in tw.t.engine._vsrs}
    idle = next(p for p in range(tw.t.problem.P) if p not in used)
    X0 = tw.t.X
    calls = []
    resolve = ts.resolve_incremental
    monkeypatch.setattr(ts, "resolve_incremental",
                        lambda *a, **k: (calls.append(1), resolve(*a, **k))[1])
    res = tw.do("fail_node", idle)
    assert res.method == "untouched" and not calls
    np.testing.assert_array_equal(tw.t.X, X0)
    assert float(tw.t.problem.NS[idle]) == 0.0
    assert tw.tm["re_embedded"] == 0
    tw.do("recover_node", idle)
    assert calls == [1]
    assert float(tw.t.problem.NS[idle]) > 0.0


def test_degrade_never_writes_the_engine_substrate(city):
    """Every problem of the engine is built on one cached substrate; a
    degraded problem takes new tensors, so a recovery sees it healthy."""
    tw = _ftwin(city)
    eng = tw.t.engine
    fresh = tp.substrate_arrays(city[1], CPU)
    node = _hosting_non_source(tw)
    tw.do("fail_node", node)
    tw.do("fail_link", 2)
    assert float(eng.problem.NS[node]) == 0.0
    assert float(eng.problem.C_net[2]) == 0.0
    for name in ("NS", "C_lan", "C_net"):
        assert bool((eng._substrate[name] == fresh[name]).all()), name
    tw.do("recover_link", 2)
    tw.do("recover_node", node)
    for name in ("NS", "C_lan", "C_net"):
        assert bool((getattr(eng.problem, name) == fresh[name]).all()), name


@pytest.mark.parametrize("mode", ["add", "wave"])
def test_source_down_arrival_parks(city, mode):
    """An arrival at a dead source parks whatever queue_rejected says,
    counts as queued and opens a strand window; a wave files it under
    ``queued`` and admits the rest; the recovery drains it."""
    tw = _ftwin(city, n=3)
    svc = tw.svc(40)[1]
    down = int(svc.src[0])
    tw.do("tick", 1.0)
    tw.do("fail_node", down)
    if mode == "add":
        jr, tr = tw.add(40, 40)
        assert jr is None and tr is None
    else:
        up = next(s for s in range(41, 200)
                  if int(tw.svc(s)[1].src[0]) != down)
        jw, twr = tw.wave([(40, 40), (up, 41)])
        assert twr.queued == jw.queued == [40]
        assert twr.admitted == jw.admitted == [41]
    tw.check()
    assert 40 in tw.t.engine.queued_sids and 40 not in tw.t.sids
    assert tw.t.stats[-1 if mode == "add" else -2].event == "strand"
    assert tw.tm.stranded_since[40] == 1.0
    assert tw.t.admission["queued"] == 1     # the arrival, not the strands
    tw.do("tick", 3.0)
    tw.do("recover_node", down)
    assert 40 in tw.t.sids and not tw.t.engine.queued_sids
    assert not tw.tm.stranded_since
    assert tw.tm.stranded_service_s >= 2.0 - 1e-9


def test_apply_fault_dispatch_and_refusals(city):
    """apply_fault dispatches every flat kind as the direct handlers do; a
    repeated fail or recover is a no-op (no count); region kinds raise."""
    tw = _ftwin(city, n=3)
    node = _hosting_non_source(tw)
    for kind, target, value in (("fail_node", node, None),
                                ("fail_node", node, None),
                                ("fail_link", 1, None),
                                ("brownout", -1, 3.0),
                                ("recover_link", 1, None),
                                ("recover_link", 1, None),
                                ("brownout_end", -1, None),
                                ("recover_node", node, None)):
        jr = tw.j.apply_fault(jdyn.FaultEvent(0.5, kind, target, value))
        tr = tw.t.apply_fault(tdyn.FaultEvent(0.5, kind, target, value))
        assert (jr is None) == (tr is None)
        tw.check()
    assert tw.tm["node_failed"] == tw.tm["node_recovered"] == 1
    assert tw.tm["link_failed"] == tw.tm["link_recovered"] == 1
    for kind in ("fail_region", "recover_region"):
        with pytest.raises(ValueError, match="federated"):
            tw.t.apply_fault(tdyn.FaultEvent(1.0, kind, 0))


def test_fault_resolve_on_reference_streams(city):
    """A mass re-embed after a node failure with the anneal on: on the
    reference's own draws (masked to the health's eligibility) the port
    lands within 5e-2 of the reference's objective, puts no VM on the
    dead node and never worsens its warm start."""
    jt, tt = city
    jprob0, tprob0 = _problems(city, 5, pad_to_rows=8)
    cdc = jt.layer_indices("cdc")[0]
    warm = np.asarray(js.coordinate(
        jprob0, np.full((jprob0.R, jprob0.V), cdc, np.int32)).X)
    srcs = set(tprob0.host.fixed_node[:, 0].tolist())
    node = next(int(x) for x in warm[:5, 1:].ravel() if int(x) not in srcs)
    jh, th = _healths(city, [("node", node)])
    jprob, tprob = jh.degrade(jprob0), th.degrade(tprob0)
    moved = sorted({r for r in range(5) if node in warm[r]})
    kw = dict(anneal_steps=200, anneal_chains=4)
    jspec, tspec = JSpec(**kw, health=jh), TSpec(**kw, health=th)
    el = tspec.masks(tprob)
    np.testing.assert_array_equal(el, jspec.masks(jprob))
    jst, tst = jp.warm_state(jprob, warm), tp.warm_state(tprob, warm)
    key = jax.random.PRNGKey(11)
    want = js.resolve_incremental(jprob, key=key, changed_rows=moved,
                                  state=jst, spec=jspec)
    streams = _ref_streams(key, 200, 4, _targets(tprob, moved), tprob, el=el)
    got = ts.resolve_incremental(tprob, changed_rows=moved, state=tst,
                                 spec=tspec, streams=streams)
    assert abs(got.objective - want.objective) <= 5e-2
    assert not (got.X[:5] == node).any()
    assert got.objective <= float(tp.objective(tprob, tst.X)) + 1e-3
    np.testing.assert_allclose(got.objective,
                               tref.placement_objective_f64(tprob, got.X),
                               rtol=1e-5, atol=5e-2)


# ---------------------------------------------------------------------------
# timelines: fault presets, FaultEvents merged with churn, replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("single_node", {}), ("single_node", dict(node=5, outage_h=3.5)),
    ("rack_storm", dict(n_nodes=3)), ("rack_storm", dict(n_nodes=20)),
    ("rack_storm", dict(nodes=[11, 4], t_fail=0.5, stagger_h=0.25)),
    ("brownout_day", dict(budget_w=123.0)),
    ("brownout_day", dict(region=2, t0=1.0, t1=2.0))],
    ids=lambda c: f"{c[0]}-{sorted(c[1])}")
def test_fault_presets_byte_equal_to_jax(city, case):
    name, kw = case
    jt, tt = city
    got = tdyn.fault_preset(name, tt, **kw)
    assert _events(got) == _events(jdyn.fault_preset(name, jt, **kw))
    assert all(isinstance(e, tdyn.FaultEvent) for e in got)
    assert [e.t for e in got] == sorted(e.t for e in got)


def test_fault_presets_and_merge_order(city):
    _, tt = city
    one = tdyn.fault_preset("single_node", tt)
    assert [e.kind for e in one] == ["fail_node", "recover_node"]
    assert one[0].target == one[1].target
    storm = tdyn.fault_preset("rack_storm", tt, n_nodes=3)
    assert len(storm) == 6 and len({e.target for e in storm}) == 3
    day = tdyn.fault_preset("brownout_day", tt, budget_w=123.0)
    assert [e.kind for e in day] == ["brownout", "brownout_end"]
    assert day[0].value == 123.0
    assert sorted(tdyn.FAULT_SCENARIOS) == sorted(jdyn.FAULT_SCENARIOS)
    with pytest.raises(ValueError, match="unknown fault preset"):
        tdyn.fault_preset("nope", tt)
    churn = [tdyn.ServiceEvent(20.0, "arrive", 7),
             tdyn.ServiceEvent(20.0, "depart", 3)]
    merged = tdyn.merge_timelines(
        churn, [tdyn.FaultEvent(20.0, "fail_node", 2),
                tdyn.FaultEvent(20.0, "recover_node", 2)])
    assert [e.kind for e in merged] == ["depart", "fail_node",
                                       "recover_node", "arrive"]


def _storm(pkg, tt):
    iot = tt.layer_indices("iot")

    def make(sid):
        return pkg.random_vsrs(1, rng=np.random.default_rng(sid), n_vms=3,
                               source_nodes=iot[:4])
    return make


@pytest.mark.parametrize("waves", [False, True], ids=["per_event", "waves"])
def test_replay_merged_timeline_closes_the_loop(city, waves):
    """The reference's churn + fault timeline in both replay modes: the
    fault events dispatch through apply_fault, the live set re-syncs, and
    the availability integral is the reference's."""
    jt, tt = city
    tw = FTwin(city, dict(QUICK))
    src = int(_storm(tvsr, tt)(1).src[0])
    streams = []
    for mod in (jdyn, tdyn):
        churn = [mod.ServiceEvent(float(i), "arrive", i) for i in range(4)]
        churn.append(mod.ServiceEvent(9.0, "depart", 0))
        faults = [mod.FaultEvent(5.0, "fail_node", src),
                  mod.FaultEvent(7.0, "recover_node", src),
                  mod.FaultEvent(8.0, "brownout", value=1e6),
                  mod.FaultEvent(8.5, "brownout_end")]
        streams.append(mod.merge_timelines(churn, faults))
    seen = []
    tw.j.replay(streams[0], _storm(jvsr, jt), waves=waves)
    tw.t.replay(streams[1], _storm(tvsr, tt), waves=waves,
                on_event=lambda ev, res: seen.append(ev.kind))
    tw.check()
    assert seen == [e.kind for e in streams[1]]
    kinds = [s.event for s in tw.t.stats]
    assert "fail_node" in kinds and "recover_node" in kinds
    assert tw.tm["node_failed"] == 1 and tw.tm["node_recovered"] == 1
    assert tw.tm["brownout"] == tw.tm["brownout_end"] == 1
    for m in (tw.jm, tw.tm):
        m.close_strands(10.0)
    assert not tw.tm.stranded_since
    a = tw.tm.availability(horizon=10.0, n_services=4)
    assert a == tw.jm.availability(horizon=10.0, n_services=4)
    assert 0.0 <= a < 1.0
    assert tw.tm.stranded_service_s > 0.0


# ---------------------------------------------------------------------------
# monitors: availability integral, reset, merge; heartbeat; straggler
# ---------------------------------------------------------------------------

def _state(m):
    return (dict(m.counters), list(m.events), m.stranded_service_s,
            dict(m.stranded_since))


def test_monitor_strand_unstrand_integral():
    out = []
    for mod in (jmon, tmon):
        m = mod.PlacementMonitor()
        m.strand(1, t=2.0)
        m.strand(1, t=3.0)                  # idempotent while open
        assert m["service_stranded"] == 1
        assert not m.unstrand(9, t=5.0)     # no window: no-op
        assert m.unstrand(1, t=5.0)
        assert m.stranded_service_s == pytest.approx(3.0)
        assert m["re_embedded"] == 1
        m.strand(2, t=6.0)
        m.unstrand(2, t=8.0, re_embedded=False)
        assert m["re_embedded"] == 1
        assert m.stranded_service_s == pytest.approx(5.0)
        assert m.availability(horizon=10.0, n_services=2) == \
            pytest.approx(0.75)
        assert m.availability(horizon=0.0, n_services=2) == 1.0
        out.append(_state(m))
    assert out[0] == out[1]


class _Registry:
    """A duck-typed telemetry registry: records inc / emit / gauge."""

    def __init__(self):
        self.calls = []

    def inc(self, name, n):
        self.calls.append(("inc", name, n))

    def emit(self, event, **kw):
        self.calls.append(("emit", event, tuple(sorted(kw.items()))))

    def gauge(self, name, value):
        self.calls.append(("gauge", name, value))


def test_monitor_reset_merge_and_telemetry_mirror():
    out = []
    for mod in (jmon, tmon):
        a = mod.PlacementMonitor(max_events=4)
        b = mod.PlacementMonitor()
        reg = _Registry()
        a.attach_telemetry(reg, prefix="cfn")
        for i in range(3):
            a.count("x", detail=f"a{i}")
        for i in range(3):
            b.count("y", detail=f"b{i}")
        b.strand(7, t=1.0)
        b.stranded_service_s = 2.5
        a.strand(7, t=0.5)
        a.merge(b)
        assert a["x"] == 3 and a["y"] == 3
        assert a["service_stranded"] == 2
        assert len(a.events) == 4
        assert a.events[-1] == ("service_stranded", "sid=7")
        assert a.stranded_service_s == pytest.approx(2.5)
        assert a.stranded_since[7] == 0.5
        assert a.snapshot() == a.counters and a.snapshot() is not a.counters
        out.append((_state(a), reg.calls))
        a.reset()
        assert not a.counters and not a.events and not a.stranded_since
        assert a.stranded_service_s == 0.0
        assert a.availability(10.0, 5) == 1.0
    assert out[0] == out[1]


def test_heartbeat_deregister_and_reset():
    for mod in (jmon, tmon):
        clock = {"t": 0.0}
        m = mod.HeartbeatMonitor(timeout_s=1.0, clock=lambda: clock["t"])
        m.register("w0")
        m.register("w1")
        clock["t"] = 5.0
        assert sorted(m.dead_workers()) == ["w0", "w1"]
        m.beat("w1")
        assert m.dead_workers() == ["w0"] and not m.healthy()
        m.deregister("w0")
        assert m.dead_workers() == [] and m.healthy()
        m.deregister("w0")                  # idempotent
        m.reset()
        assert m.healthy() and not m.last_beat


def test_straggler_reset_clears_history():
    for mod in (jmon, tmon):
        t = mod.StragglerTracker(threshold=3.0)
        for i in range(8):
            assert not t.record(i, 1.0)
        assert t.record(8, 10.0)
        t.reset()
        assert t.flagged_steps == [8]
        assert not t.record(9, 10.0)


def test_fault_package_exports():
    import repro_torch.fault as tf
    from repro_torch.fault import runner
    assert sorted(tf.__all__) == ["HeartbeatMonitor", "PlacementMonitor",
                                  "ResilientTrainer", "RunReport",
                                  "SimulatedFailure", "StragglerTracker"]
    assert tf.PlacementMonitor is tmon.PlacementMonitor
    assert tf.ResilientTrainer is runner.ResilientTrainer
