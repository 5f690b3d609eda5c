"""Wave-batched churn, the priority rejection queue, preemption and the
amortized defrag tick of the PyTorch port against the JAX package, on the
CPU and the paper topology (the template is ``tests/test_waves.py``).

Every engine case runs the same services, made from numpy seeds, through a
JAX ``CFNSession`` and a port ``CFNSession(device="cpu")`` under the
deterministic spec of ``tests/test_torch_online.py`` (coordinate, no
anneal, no periodic defrag).  They must agree on placements (equal),
objectives (rtol 1e-5 / atol 5e-2), live sids, ``queued_sids``,
``admission`` and the ``WaveResult`` lists (equal).  Timelines are
numpy-only and byte-equal.  ``resolve_wave`` on the reference's random
streams lands within 5e-2 of the reference's objective.  The reference's
retrace counts have no counterpart (the port compiles nothing); their
cases check the padded position lists' lengths instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _hyp import given, settings, st

from repro.api import CFNSession as JSession, PlacementSpec as JSpec
from repro.core import dynamic as jdyn, power as jp, solvers as js, \
    topology as jtopo, vsr as jvsr
from repro_torch.api import CFNSession as TSession, PlacementSpec as TSpec
from repro_torch.core import dynamic as tdyn, power as tp, \
    solvers as ts, topology as ttopo, vsr as tvsr
from repro_torch.kernels import ref as tref
from test_torch_online import _ref_streams

CPU = "cpu"
DET = dict(method="coordinate", anneal_steps=0, defrag_every=0)
OBJ_TOL = dict(rtol=1e-5, atol=5e-2)


@pytest.fixture(scope="module")
def paper():
    return jtopo.paper_topology(), ttopo.paper_topology()


def _svcs(pkg, topo, n, seed0=0, n_vms=3):
    """n R=1 services of ``pkg``'s vsr module, the reference test's."""
    iot = topo.layer_indices("iot")
    return [pkg.random_vsrs(1, rng=np.random.default_rng(seed0 + i),
                            n_vms=n_vms, source_nodes=iot[:4])
            for i in range(n)]


class Twin:
    """One JAX and one port session fed the same calls (services by seed,
    ``(seed, sid[, priority])`` tuples for a wave's arrivals)."""

    def __init__(self, paper, spec_kw):
        self.jt, self.tt = paper
        self.j = JSession(self.jt, JSpec(**spec_kw),
                          key=jax.random.PRNGKey(7))
        self.t = TSession(self.tt, TSpec(**spec_kw), device=CPU)

    def svc(self, seed):
        return (_svcs(jvsr, self.jt, 1, seed)[0],
                _svcs(tvsr, self.tt, 1, seed)[0])

    def add(self, seed, sid, priority=None):
        jsv, tsv = self.svc(seed)
        return (self.j.add(jsv, sid=sid, priority=priority),
                self.t.add(tsv, sid=sid, priority=priority))

    def wave(self, arrivals=(), departures=()):
        jarr, tarr = [], []
        for seed, *rest in arrivals:
            jsv, tsv = self.svc(seed)
            jarr.append((jsv, *rest))
            tarr.append((tsv, *rest))
        return (self.j.apply_wave(jarr, departures),
                self.t.apply_wave(tarr, departures))

    def call(self, name, *args):
        return (getattr(self.j.engine, name)(*args),
                getattr(self.t.engine, name)(*args))

    def check(self):
        """The two engines agree (placements equal, objectives to OBJ_TOL,
        sids, queue, counters and events equal)."""
        j, t = self.j.engine, self.t.engine
        if t.X is None:
            assert j.X is None
        else:
            np.testing.assert_array_equal(t.X, np.asarray(j.X))
            np.testing.assert_allclose(t.objective(), j.objective(),
                                       **OBJ_TOL)
        assert t.sids == j.sids
        assert t.queued_sids == j.queued_sids
        assert t.admission == j.admission
        assert t._prio == j._prio
        assert [(s.event, s.method, s.n_live) for s in t.stats] == \
            [(s.event, s.method, s.n_live) for s in j.stats]
        np.testing.assert_allclose([s.objective for s in t.stats],
                                   [s.objective for s in j.stats], **OBJ_TOL)


def _twin(paper, n=4, **spec_kw):
    """A twin seeded with n live services by the per-event path."""
    tw = Twin(paper, dict(DET, **spec_kw))
    for i in range(n):
        jr, tr = tw.add(i, i)
        assert jr is not None and tr is not None
    tw.check()
    return tw


def _same_wave(jw, tw):
    for name in ("sids", "admitted", "rejected", "queued", "departed",
                 "n_preempted"):
        assert getattr(tw, name) == getattr(jw, name), name
    if jw.result is None:
        assert tw.result is None
    else:
        np.testing.assert_allclose(tw.result.objective, jw.result.objective,
                                   **OBJ_TOL)
        assert tw.result.method == jw.result.method


# ---------------------------------------------------------------------------
# a wave of one is the per-event path; the empty wave
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["arrive", "depart"])
def test_wave_of_one_is_the_per_event_path(paper, kind):
    """A one-event wave gives add's / remove's placement, power and
    counters in the port, and the reference's wave result."""
    tw = _twin(paper)
    per_event = _twin(paper)
    if kind == "arrive":
        res = per_event.t.add(per_event.svc(50)[1], sid=99)
        jw, twr = tw.wave([(50, 99)])
        assert twr.admitted == [99] and twr.sids == [99]
    else:
        res = per_event.t.remove(2)
        jw, twr = tw.wave(departures=[2])
        assert twr.departed == [2]
    np.testing.assert_array_equal(tw.t.X, per_event.t.X)
    assert tw.t.sids == per_event.t.sids
    assert tw.t.admission == per_event.t.admission
    assert float(res.power) == float(twr.result.power)
    want = tref.placement_objective_f64(tw.t.problem, tw.t.X)
    assert want == tref.placement_objective_f64(per_event.t.problem,
                                                per_event.t.X)
    _same_wave(jw, twr)
    tw.check()


def test_empty_wave_is_a_noop(paper):
    tw = _twin(paper, n=2)
    before = tw.t.X
    jw, twr = tw.wave()
    assert twr.admitted == [] and twr.departed == []
    np.testing.assert_array_equal(tw.t.X, before)
    _same_wave(jw, twr)
    tw.check()


# ---------------------------------------------------------------------------
# wave semantics: same-tick replace, accounting, validation
# ---------------------------------------------------------------------------

def test_wave_replace_keeps_live_count_and_bucket(paper):
    tw = _twin(paper)
    R_pad = tw.t.problem.R
    jw, twr = tw.wave([(70, 10), (71, 11)], departures=[0, 1])
    assert tw.t.n_live == 4 and tw.t.problem.R == R_pad
    assert set(tw.t.sids) == {2, 3, 10, 11}
    assert set(twr.admitted) == {10, 11} and twr.departed == [0, 1]
    assert sorted(twr.admitted + twr.rejected + twr.queued) == \
        sorted(twr.sids)
    assert twr.result.method == "wave"
    obj = tref.placement_objective_f64(tw.t.problem, tw.t.X)
    assert abs(obj - twr.result.objective) <= 5e-2 + 1e-5 * abs(obj)
    _same_wave(jw, twr)
    tw.check()


@pytest.mark.parametrize("case", [
    (KeyError, dict(departures=[5])),
    (ValueError, dict(departures=[0, 0])),
    (ValueError, dict(arrivals=[0])),             # sid 0 already live
    (ValueError, dict(arrivals=[7, 7])),          # duplicate arrival sid
    (ValueError, dict(arrivals=["R2"]))],         # not one service
    ids=["unknown_departure", "duplicate_departure", "live_sid",
         "duplicate_arrival", "two_rows"])
def test_wave_validates_inputs(paper, case):
    """Both packages refuse the same malformed waves with the same error,
    and leave the engine as it was."""
    err, kw = case
    tw = _twin(paper, n=1)
    jt, tt = paper
    for pkg, topo, ses in ((jvsr, jt, tw.j), (tvsr, tt, tw.t)):
        sv = _svcs(pkg, topo, 1)[0]
        two = pkg.random_vsrs(2, rng=3, source_nodes=[0])
        arr = [(two if a == "R2" else sv, None if a == "R2" else a)
               for a in kw.get("arrivals", [])]
        with pytest.raises(err):
            ses.apply_wave(arr, kw.get("departures", ()))
    tw.check()


# ---------------------------------------------------------------------------
# priority admission, queue-drain order, preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("priority", [2, -1])
def test_priority_classes_validated(paper, priority):
    tw = Twin(paper, dict(DET, priority_classes=2))
    for ses, sv in zip((tw.j, tw.t), tw.svc(0)):
        with pytest.raises(ValueError, match="priority"):
            ses.add(sv, priority=priority)
    with pytest.raises(ValueError):
        TSpec(priority_classes=0)
    tw.check()


def test_queue_drains_in_priority_order(paper):
    tw = Twin(paper, dict(DET, priority_classes=3, queue_rejected=True))
    tw.add(0, 0)
    tw.call("brownout", 0.0)            # nothing fits a zero-watt budget
    for sid, prio in [(1, 2), (2, 0), (3, 1)]:
        jr, tr = tw.add(40 + sid - 1, sid, prio)
        assert jr is None and tr is None
    assert tw.t.engine.queued_sids == [2, 3, 1]
    tw.check()
    tw.call("brownout_end")
    assert tw.t.sids == [0, 2, 3, 1]      # class 0 first, then 1, then 2
    assert not tw.t.engine._queue
    tw.check()


def test_departure_drains_queue_until_first_rerejection(paper):
    tw = _twin(paper, n=2, queue_rejected=True)
    tw.call("brownout", 0.0)
    for i in range(2, 5):
        jr, tr = tw.add(i, i)
        assert jr is None and tr is None
    assert len(tw.t.engine._queue) == 3
    tw.j.remove(0)
    tw.t.remove(0)                        # capacity up, budget still zero
    assert set(tw.t.sids) == {1}
    assert len(tw.t.engine._queue) == 3   # the first retry re-parked
    assert tw.t.admission == dict(admitted=2, rejected=3, queued=3,
                                  preempted=0)
    tw.check()
    tw.call("brownout_end")               # budget restored: a full drain
    assert set(tw.t.sids) == {1, 2, 3, 4}
    assert not tw.t.engine._queue
    tw.check()


def test_preemption_parks_lower_class_for_higher(paper):
    tw = Twin(paper, dict(DET, priority_classes=2, preempt=True,
                          queue_rejected=True))
    tw.add(0, 0, 0)
    tw.add(1, 1, 1)                       # the victim
    tw.call("brownout", 0.0)
    tw.add(2, 2, 0)
    eng = tw.t.engine
    assert eng.admission["preempted"] == 1
    assert 1 in eng.queued_sids and 0 in eng.sids
    assert all(eng._prio[eng.sids.index(sid)] == 0 for sid in eng.sids)
    assert [s.event for s in eng.stats][-3:] == ["remove", "preempt",
                                                 "reject"]
    tw.check()
    tw.call("brownout_end")
    assert set(tw.t.sids) >= {0, 1}       # the victim returns
    tw.check()


@pytest.mark.parametrize("classes", [(0, 1), (1, 0), (0, 0)],
                         ids=["low_last", "low_first", "one_class"])
def test_wave_admission_is_priority_ordered_under_budget(paper, classes):
    """Under a zero budget a wave refuses its lowest class first and,
    within a class, the arrival with the highest attributed watts; both
    arrivals end queued, in the reference's order."""
    tw = Twin(paper, dict(DET, priority_classes=2, queue_rejected=True))
    tw.add(0, 0)
    tw.call("brownout", 0.0)
    jw, twr = tw.wave([(60, 1, classes[0]), (61, 2, classes[1])])
    assert sorted(twr.queued) == [1, 2] and twr.admitted == []
    if classes[0] != classes[1]:
        low = 2 if classes[1] else 1
        assert twr.queued[0] == low             # refused first
        assert tw.t.engine.queued_sids == [3 - low, low]
    _same_wave(jw, twr)
    tw.check()


def test_wave_preemption_defers_to_the_per_event_path(paper):
    """With preemption a power-refused wave arrival retries per event: the
    class-0 arrival parks the class-1 live services, newest first."""
    tw = Twin(paper, dict(DET, priority_classes=2, queue_rejected=True,
                          preempt=True))
    for i, prio in enumerate([0, 0, 1, 1]):
        tw.add(i, i, prio)
    tw.call("brownout", 0.0)
    jw, twr = tw.wave([(80, 10, 0), (81, 11, 1)])
    assert sorted(twr.queued) == [10, 11] and twr.n_preempted == 2
    assert tw.t.engine.queued_sids == [10, 11, 3, 2]
    assert tw.t.admission == dict(admitted=4, rejected=2, queued=2,
                                  preempted=2)
    _same_wave(jw, twr)
    tw.check()
    tw.call("brownout_end")
    assert tw.t.sids == [0, 1, 10, 11, 3, 2]
    tw.check()


# ---------------------------------------------------------------------------
# the amortized defrag tick
# ---------------------------------------------------------------------------

def test_defrag_tick_never_regresses_and_carries_cursor(paper):
    tw = _twin(paper, n=5, defrag_rows_per_tick=2)
    objs = [tw.t.objective()]
    cursors = [tw.t.engine._defrag_cursor]
    for _ in range(6):
        jr, tr = tw.call("defrag_tick")
        assert (jr is None) == (tr is None)
        if tr is not None:
            assert tr.method == jr.method == "defrag_tick"
        objs.append(tw.t.objective())
        cursors.append(tw.t.engine._defrag_cursor)
        assert cursors[-1] == tw.j.engine._defrag_cursor
        tw.check()
    for prev, cur in zip(objs, objs[1:]):
        assert cur <= prev + 1e-9
    for prev, cur in zip(cursors, cursors[1:]):
        assert cur == (prev + 2) % tw.t.n_live


def test_defrag_rows_per_tick_disables_periodic_full_defrag(paper):
    tw = _twin(paper, n=6, defrag_every=2, defrag_rows_per_tick=1)
    assert all(s.method != "defrag" for s in tw.t.stats if s.event == "add")
    assert not tw.t.engine._defrag_due()


def test_defrag_tick_empty_engine_is_noop(paper):
    tw = Twin(paper, dict(DET, defrag_rows_per_tick=2))
    assert tw.call("defrag_tick") == (None, None)


def test_wave_and_defrag_tick_bucket_lengths(paper, monkeypatch):
    """The reference pads each position list to a power-of-two bucket so
    its jitted sweeps compile once a bucket; the port pads the same: a
    wave's targeted sweeps over _pow2 of its free positions, its polish
    over R x (V - 1), a defrag tick over _pow2 of its rows' positions --
    the same lengths at the second wave and tick of a bucket."""
    tw = _twin(paper, n=6, defrag_rows_per_tick=3)
    lengths = []
    sweep = ts._sweep
    monkeypatch.setattr(ts, "_sweep", lambda p, a, s, pos, el=None: (
        lengths.append(len(pos)), sweep(p, a, s, pos, el))[1])
    seen = []
    for seed in (90, 93):
        del lengths[:]
        tw.wave([(seed + i, seed + i) for i in range(3)],
                departures=tw.t.sids[:3])
        p = tw.t.problem
        n_pos = int((~p.host.fixed_mask[[3, 4, 5]]).sum())
        assert n_pos == 6
        assert lengths == [8, 8] + [p.R * (p.V - 1)] * 2
        cursor = tw.t.engine._defrag_cursor
        n_tick = int((~p.host.fixed_mask[[cursor, cursor + 1,
                                          cursor + 2]]).sum())
        del lengths[:]
        tw.call("defrag_tick")
        assert lengths == [ts._pow2(n_tick)] == [8]
        seen.append(list(lengths))
        tw.check()
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# timelines: merge_timelines, iter_waves, flash_crowd_trace
# ---------------------------------------------------------------------------

def _events(ev):
    return [(type(e).__name__, e.t, e.kind, getattr(e, "sid", None),
             getattr(e, "target", None), getattr(e, "value", None))
            for e in ev]


def _waves(waves):
    return [_events(w) for w in waves]


@pytest.mark.parametrize("args", [(4, 3, 4, 0, True), (3, 2, 3, 0, False),
                                  (64, 4, 16, 0, True), (5, 3, 5, 7, True),
                                  (2, 3, 4, 2, False), (4, 2, 4, 3, True)])
def test_flash_crowd_trace_byte_equal_to_jax(args):
    n, w, size, seed, replace = args
    got = tdyn.flash_crowd_trace(n, w, size, rng=seed, replace=replace)
    want = jdyn.flash_crowd_trace(n, w, size, rng=seed, replace=replace)
    assert _events(got) == _events(want)
    assert _waves(tdyn.iter_waves(got)) == _waves(jdyn.iter_waves(want))
    # a generator argument draws the same stream as its seed
    gen = tdyn.flash_crowd_trace(n, w, size, rng=np.random.default_rng(seed),
                                 replace=replace)
    assert _events(gen) == _events(got)


def _mixed_timeline(mod, seed):
    rng = np.random.default_rng(seed)
    events = []
    for t in range(int(rng.integers(1, 4))):
        for _ in range(int(rng.integers(1, 6))):
            kind = "arrive" if rng.random() < 0.5 else "depart"
            events.append(mod.ServiceEvent(float(t), kind,
                                           int(rng.integers(0, 50))))
    faults = [mod.FaultEvent(float(rng.integers(0, 3)), k, int(n))
              for k, n in zip(("fail_node", "recover_node", "brownout"),
                              rng.integers(0, 20, 3))]
    order = rng.permutation(len(events))
    return [events[i] for i in order], faults


@settings(deadline=None, max_examples=30)
@given(seed=st.integers(0, 10_000))
def test_merge_and_iter_waves_byte_equal_to_jax(seed):
    """Property: on any shuffled same-tick mix of churn and fault events
    the port's merge_timelines / iter_waves give the reference's events
    and waves, every wave departures first, each fault its own wave."""
    tev, tfaults = _mixed_timeline(tdyn, seed)
    jev, jfaults = _mixed_timeline(jdyn, seed)
    merged = tdyn.merge_timelines(tev, tfaults)
    assert _events(merged) == _events(jdyn.merge_timelines(jev, jfaults))
    waves = list(tdyn.iter_waves(merged))
    assert _waves(waves) == _waves(jdyn.iter_waves(
        jdyn.merge_timelines(jev, jfaults)))
    assert sum(len(w) for w in waves) == len(tev) + len(tfaults)
    for wave in waves:
        assert len({e.t for e in wave}) == 1
        if isinstance(wave[0], tdyn.FaultEvent):
            assert len(wave) == 1
            continue
        kinds = [e.kind for e in wave]
        if "arrive" in kinds:
            assert all(k == "arrive" for k in kinds[kinds.index("arrive"):])


def test_fault_events_are_single_event_barrier_waves():
    events = tdyn.merge_timelines(
        [tdyn.ServiceEvent(1.0, "arrive", 0),
         tdyn.ServiceEvent(1.0, "depart", 9),
         tdyn.ServiceEvent(2.0, "arrive", 1)],
        [tdyn.FaultEvent(1.0, "fail_node", 3)])
    assert [[e.kind for e in w] for w in tdyn.iter_waves(events)] == \
        [["depart"], ["fail_node"], ["arrive"], ["arrive"]]


# ---------------------------------------------------------------------------
# replay(waves=True)
# ---------------------------------------------------------------------------

def _make(pkg, topo, seed0):
    return lambda sid: _svcs(pkg, topo, 1, seed0 + sid)[0]


@pytest.mark.parametrize("preset", [
    ("replace", (4, 3, 4), dict(rng=0, replace=True), dict()),
    ("burst", (3, 2, 3), dict(rng=0, replace=False), dict()),
    ("ticks", (4, 2, 4), dict(rng=3), dict(defrag_rows_per_tick=2)),
    ("queue", (3, 3, 4), dict(rng=1),
     dict(power_budget_w=7.0, queue_rejected=True))],
    ids=lambda p: p[0])
def test_replay_waves_matches_jax(paper, preset):
    """A flash crowd replayed in waves: the reference's live set, stats,
    admission counters and placement; the per-event replay ends on the
    same live set."""
    _, args, kw, spec_kw = preset
    jt, tt = paper
    tev = tdyn.flash_crowd_trace(*args, **kw)
    jev = jdyn.flash_crowd_trace(*args, **kw)
    tw = Twin(paper, dict(DET, **spec_kw))
    seen = []
    tw.j.replay(jev, _make(jvsr, jt, 100), waves=True)
    tw.t.replay(tev, _make(tvsr, tt, 100), waves=True,
                on_event=lambda ev, wr: seen.append((ev.sid, type(wr))))
    assert [s for s, _ in seen] == [e.sid for e in tev]
    assert all(k is tdyn.WaveResult for _, k in seen)
    tw.check()
    if spec_kw.get("queue_rejected"):
        # two arrivals of the first wave queue, a departure wave drains them
        assert tw.t.admission["queued"] == 2 and not tw.t.engine._queue
    if kw.get("replace", True):
        assert tw.t.n_live == args[0]
    else:
        assert set(tw.t.sids) == set(range(args[0]))
    per_event = Twin(paper, dict(DET, **spec_kw))
    per_event.j.replay(jev, _make(jvsr, jt, 100))
    per_event.t.replay(tev, _make(tvsr, tt, 100))
    per_event.check()
    if not spec_kw.get("queue_rejected"):
        # under a budget the two modes admit in another order
        assert set(per_event.t.sids) == set(tw.t.sids)


def test_replay_departure_cancels_a_queued_service(paper):
    """A departure of a parked (not live) service cancels it in the queue,
    in both replay modes, as the reference does."""
    events = [tdyn.ServiceEvent(0.0, "arrive", 0),
              tdyn.ServiceEvent(1.0, "arrive", 1),
              tdyn.ServiceEvent(2.0, "depart", 1),
              tdyn.ServiceEvent(3.0, "depart", 0)]
    jevents = [jdyn.ServiceEvent(e.t, e.kind, e.sid) for e in events]
    jt, tt = paper
    for waves in (False, True):
        tw = Twin(paper, dict(DET, queue_rejected=True))
        tw.add(0, 5)
        tw.call("brownout", 0.0)
        tw.j.replay(jevents, _make(jvsr, jt, 200), waves=waves)
        tw.t.replay(events, _make(tvsr, tt, 200), waves=waves)
        assert tw.t.sids == [5] and tw.t.engine.queued_sids == []
        assert tw.t.admission["queued"] == 2
        tw.check()


# ---------------------------------------------------------------------------
# resolve_wave on the reference's streams
# ---------------------------------------------------------------------------

def test_resolve_wave_on_reference_streams(paper):
    """A wave (one departure, two arrivals) carried into one warm state:
    on the reference's own draws the port lands within 5e-2 of the
    reference's objective, keeps pins, never worsens its warm start, and
    pads its changed positions to _pow2 of their count."""
    jt, tt = paper
    kw = dict(rng=31, source_nodes=[0, 3, 5])
    jbase, tbase = jvsr.random_vsrs(5, **kw), tvsr.random_vsrs(5, **kw)
    jprob0 = jp.build_problem(jt, jbase)
    cdc = jt.layer_indices("cdc")[0]
    warm = np.asarray(js.coordinate(
        jprob0, np.full((5, jprob0.V), cdc, np.int32)).X)
    tprob0 = tp.build_problem(tt, tbase, device=CPU)
    jdet = jp.detach_vsrs(jprob0, jp.init_state(jprob0, jnp.asarray(warm)),
                          [1])
    tdet = tp.detach_vsrs(tprob0, tp.init_state(tprob0, warm), [1])
    keep = [0, 2, 3, 4]
    nkw = dict(rng=500, source_nodes=[0])
    cut = lambda pkg, v: pkg.VSRBatch(F=v.F[keep], H=v.H[keep],
                                      src=v.src[keep],
                                      input_vm=v.input_vm[keep])
    jv = cut(jvsr, jbase).concat(jvsr.random_vsrs(2, **nkw))
    tv = cut(tvsr, tbase).concat(tvsr.random_vsrs(2, **nkw))
    jprob = jp.build_problem(jt, jv, pad_to_rows=8)
    tprob = tp.build_problem(tt, tv, pad_to_rows=8, device=CPU)
    row_map = keep + [-1] * 4
    jst = jp.warm_state(jprob, warm, prev_loads=(
        jdet.omega, jdet.tm, jdet.theta, jdet.lam), row_map=row_map)
    tst = tp.warm_state(tprob, warm, prev_loads=(
        tdet.omega, tdet.tm, tdet.theta, tdet.lam), row_map=row_map)
    new_rows = [4, 5]
    key = jax.random.PRNGKey(3)
    skw = dict(anneal_steps=200, anneal_chains=4,
               pad_positions_to=tprob.R * (tprob.V - 1))
    want = js.resolve_wave(jprob, jst, new_rows, key=key, **skw)
    free = tp.build_aux(tprob).free_pos.numpy()
    pos = free[np.isin(free[:, 0], new_rows)]
    bucket = ts._pow2(pos.shape[0])
    assert bucket == 4 and pos.shape[0] == 4
    streams = _ref_streams(key, 200, 4, ts._pad_positions(pos, bucket), tprob)
    got = ts.resolve_wave(tprob, tst, new_rows, streams=streams, **skw)
    assert got.method == want.method == "wave"
    assert abs(got.objective - want.objective) <= 5e-2
    assert len(got.history) == len(want.history)
    fixed = tprob.fixed_mask.numpy()
    np.testing.assert_array_equal(got.X[fixed],
                                  tprob.fixed_node.numpy()[fixed])
    assert got.objective <= float(tp.objective(tprob, tst.X)) + 1e-3
    # without the anneal the wave re-solve is deterministic: rtol 1e-5
    det = dict(skw, anneal_steps=0)
    np.testing.assert_allclose(
        ts.resolve_wave(tprob, tst, new_rows, **det).objective,
        js.resolve_wave(jprob, jst, new_rows, **det).objective, rtol=1e-5)
