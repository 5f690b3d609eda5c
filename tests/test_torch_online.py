"""The online churn engine of the PyTorch port against the JAX package, on
the CPU: the service-granular state operations (``service_loads``,
``attach_vsrs`` / ``detach_vsrs``, ``warm_state``, ``attribute_power``),
``resolve_incremental`` on the reference's own random streams, the
``OnlineEmbedder`` event loop and its session, and the timelines.

Inputs are numpy arrays from seeds, fed to both packages; the port runs on
the CPU.  Tolerances: placements byte-equal where both packages compute
them the same way; carried loads rtol 1e-5 / atol 1e-2 (float32 sums of
float64 service slices); objectives from carried loads 1e-3 + 1e-6 |obj|
of a fresh build (the reference's bound), and 5e-2 + 1e-5 |obj| of the
float64 oracle; per-service watts rtol 1e-5; a stochastic re-solve on the
reference's streams within 5e-2 of the reference's objective, and a
deterministic one (no anneal) rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CFNSession as JSession, PlacementSpec as JSpec
from repro.core import dynamic as jdyn, power as jp, solvers as js, \
    topology as jtopo, vsr as jvsr
from repro.kernels import ref as jref
from repro_torch.api import CFNSession, PlacementSpec as TSpec
from repro_torch.core import dynamic as tdyn, embed as tembed, \
    power as tp, solvers as ts, topology as ttopo, vsr as tvsr
from repro_torch.kernels import ref as tref

CPU = "cpu"
CITY = dict(n_olt=2, onus_per_olt=4, iot_per_onu=8)
SOURCES = {"paper": [0, 3, 5], "city": [0, 9, 17, 40]}
LOAD_TOL = dict(rtol=1e-5, atol=1e-2)


@pytest.fixture(scope="module")
def paper():
    return jtopo.paper_topology(), ttopo.paper_topology()


@pytest.fixture(scope="module")
def city():
    return jtopo.city_scale(**CITY), ttopo.city_scale(**CITY)


def _problems(topos, n, seed, sources, **kw):
    jt, tt = topos
    vkw = dict(rng=seed, source_nodes=sources, **kw)
    return (jp.build_problem(jt, jvsr.random_vsrs(n, **vkw)),
            tp.build_problem(tt, tvsr.random_vsrs(n, **vkw), device=CPU))


def _random_X(prob, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, prob.P, size=(prob.R, prob.V)).astype(np.int32)


def _assert_same_state(got: tp.PlacementState, want, obj_rel=1e-6):
    """A port state against a reference state: X byte-equal, loads
    rtol 1e-5 / atol 1e-2, objective 1e-3 + obj_rel |obj|."""
    assert got.X.numpy().tobytes() == np.asarray(want.X).tobytes()
    for name in ("omega", "tm", "theta", "lam"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **LOAD_TOL)
    assert abs(float(got.obj) - float(want.obj)) <= \
        1e-3 + obj_rel * abs(float(want.obj))


def _services(n, seed0=100, **kw):
    kw.setdefault("source_nodes", [0])
    return [tvsr.random_vsrs(1, rng=seed0 + i, **kw) for i in range(n)]


def _jservices(n, seed0=100, **kw):
    kw.setdefault("source_nodes", [0])
    return [jvsr.random_vsrs(1, rng=seed0 + i, **kw) for i in range(n)]


# ---------------------------------------------------------------------------
# service_loads / attach / detach / warm_state / attribute_power
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", ["paper", "city"])
def test_service_loads_matches_jax(scale, request):
    jprob, tprob = _problems(request.getfixturevalue(scale), 6, 3,
                             SOURCES[scale])
    X = _random_X(tprob, 4)
    for rows in ([0], [2, 4], list(range(6))):
        want = jp.service_loads(jprob, X, rows)
        got = tp.service_loads(tprob, X, rows)
        for name, a, b in zip(("omega", "tm", "theta", "lam"), got, want):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, b, err_msg=name, **LOAD_TOL)
    # the slices of all rows add up to the full load build
    full = tp.init_state(tprob, X)
    om, tm, th, lm = tp.service_loads(tprob, full.X, list(range(6)))
    for a, b in zip((om, tm, th, lm), (full.omega, full.tm, full.theta,
                                       full.lam)):
        np.testing.assert_allclose(a, b.numpy(), **LOAD_TOL)


@pytest.mark.parametrize("scale", ["paper", "city"])
def test_attach_detach_roundtrip_matches_jax_and_f64(scale, request):
    """detach(attach) is the identity; each detached state equals the
    reference's, and its objective is the float64 oracle's of the problem
    without that service."""
    topos = request.getfixturevalue(scale)
    src = SOURCES[scale]
    jprob, tprob = _problems(topos, 6, 11, src)
    X = _random_X(tprob, 11)
    st0 = tp.init_state(tprob, X)
    jst0 = jp.init_state(jprob, jnp.asarray(X))
    vs = tvsr.random_vsrs(6, rng=11, source_nodes=src)
    for r in (0, 3, 5):
        det = tp.detach_vsrs(tprob, st0, [r])
        _assert_same_state(det, jp.detach_vsrs(jprob, jst0, [r]))
        back = tp.attach_vsrs(tprob, det, [r])
        _assert_same_state(back, jp.attach_vsrs(jprob, jp.detach_vsrs(
            jprob, jst0, [r]), [r]))
        for name in ("omega", "tm", "theta", "lam"):
            np.testing.assert_allclose(getattr(back, name).numpy(),
                                       getattr(st0, name).numpy(),
                                       err_msg=name, **LOAD_TOL)
        assert abs(float(back.obj) - float(st0.obj)) <= \
            1e-3 + 1e-6 * abs(float(st0.obj))
        keep = [i for i in range(6) if i != r]
        red = tvsr.VSRBatch(F=vs.F[keep], H=vs.H[keep], src=vs.src[keep],
                            input_vm=vs.input_vm[keep])
        prob_red = tp.build_problem(topos[1], red, device=CPU)
        want = tref.placement_objective_f64(prob_red,
                                            st0.X.numpy()[keep])
        assert abs(float(det.obj) - want) <= 5e-2 + 1e-5 * abs(want)


def test_attach_with_explicit_rows_matches_jax(paper):
    """attach_vsrs(X_rows=...) writes the placement (pins applied) and its
    loads in one step: the reference's state and a fresh init_state."""
    jprob, tprob = _problems(paper, 4, 3, [0])
    X = _random_X(tprob, 3)
    new_row = np.random.default_rng(7).integers(
        0, tprob.P, size=(1, tprob.V)).astype(np.int32)
    st0 = tp.init_state(tprob, X)
    got = tp.attach_vsrs(tprob, tp.detach_vsrs(tprob, st0, [1]), [1],
                         X_rows=new_row)
    jst0 = jp.init_state(jprob, jnp.asarray(X))
    _assert_same_state(got, jp.attach_vsrs(
        jprob, jp.detach_vsrs(jprob, jst0, [1]), [1], X_rows=new_row))
    X2 = st0.X.numpy().copy()
    X2[1] = new_row[0]
    want = tp.init_state(tprob, X2)
    np.testing.assert_array_equal(got.X.numpy(), want.X.numpy())
    assert abs(float(got.obj) - float(want.obj)) <= \
        1e-3 + 1e-6 * abs(float(want.obj))


def test_warm_state_grow_and_shrink_matches_jax(paper):
    """Carrying loads through an arrival (grow, with a narrower service
    padded to the width) and a departure (shrink, loads from detach) gives
    the reference's states and a fresh build's objective."""
    jt, tt = paper
    kw = dict(rng=0, n_vms=4, source_nodes=[0])
    jwide, twide = jvsr.random_vsrs(3, **kw), tvsr.random_vsrs(3, **kw)
    jprob, tprob = jp.build_problem(jt, jwide), tp.build_problem(
        tt, twide, device=CPU)
    X = _random_X(tprob, 1)
    st0, jst0 = tp.init_state(tprob, X), jp.init_state(jprob,
                                                       jnp.asarray(X))
    loads = (st0.omega, st0.tm, st0.theta, st0.lam)
    jloads = (jst0.omega, jst0.tm, jst0.theta, jst0.lam)

    nkw = dict(rng=7, n_vms=2, source_nodes=[0])
    jprob_g = jp.build_problem(jt, jwide.concat(jvsr.random_vsrs(1, **nkw)))
    tprob_g = tp.build_problem(tt, twide.concat(tvsr.random_vsrs(1, **nkw)),
                               device=CPU)
    wg = tp.warm_state(tprob_g, st0.X, prev_loads=loads)
    _assert_same_state(wg, jp.warm_state(jprob_g, np.asarray(jst0.X),
                                         prev_loads=jloads))
    fresh = tp.init_state(tprob_g, wg.X)
    assert abs(float(wg.obj) - float(fresh.obj)) <= \
        1e-3 + 1e-6 * abs(float(fresh.obj))
    np.testing.assert_array_equal(wg.X.numpy()[:3], st0.X.numpy())
    # no carried loads: a full build
    _assert_same_state(tp.warm_state(tprob_g, st0.X),
                       jp.warm_state(jprob_g, np.asarray(jst0.X)))

    keep = [0, 2]
    det = tp.detach_vsrs(tprob, st0, [1])
    jdet = jp.detach_vsrs(jprob, jst0, [1])
    cut = lambda v: type(v)(F=v.F[keep], H=v.H[keep], src=v.src[keep],
                            input_vm=v.input_vm[keep])
    tprob_s = tp.build_problem(tt, cut(twide), device=CPU)
    ws = tp.warm_state(tprob_s, st0.X, row_map=keep,
                       prev_loads=(det.omega, det.tm, det.theta, det.lam))
    _assert_same_state(ws, jp.warm_state(
        jp.build_problem(jt, cut(jwide)), np.asarray(jst0.X), row_map=keep,
        prev_loads=(jdet.omega, jdet.tm, jdet.theta, jdet.lam)))
    fresh_s = tp.init_state(tprob_s, ws.X)
    assert abs(float(ws.obj) - float(fresh_s.obj)) <= \
        1e-3 + 1e-6 * abs(float(fresh_s.obj))
    np.testing.assert_array_equal(ws.X.numpy(), st0.X.numpy()[keep])


def test_warm_state_rejects_bad_row_map(paper):
    _, tprob = _problems(paper, 2, 0, [0])
    with pytest.raises(ValueError, match="row_map"):
        tp.warm_state(tprob, np.zeros((2, 3), np.int32), row_map=[0])


@pytest.mark.parametrize("scale", ["paper", "city"])
def test_attribute_power_matches_jax(scale, request):
    """Per-service watts equal the reference's (rtol 1e-5) and sum to the
    total, also over the real rows of a bucket-padded problem."""
    topos = request.getfixturevalue(scale)
    jprob, tprob = _problems(topos, 5, 21, SOURCES[scale])
    X = _random_X(tprob, 21)
    bd = tp.evaluate(tprob, X)
    got = tp.attribute_power(tprob, X, bd)
    want = jp.attribute_power(jprob, X)
    assert got.shape == (5,) and np.all(got >= -1e-9)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got.sum(), float(bd.total), rtol=1e-5)
    # numpy breakdown (a SolveResult's) and bucket pad rows
    res = ts._result(tprob, X, "x")
    np.testing.assert_allclose(tp.attribute_power(tprob, X, res.breakdown),
                               got, rtol=1e-12)
    jt, tt = topos
    kw = dict(rng=21, source_nodes=SOURCES[scale])
    tpad = tp.build_problem(tt, tvsr.random_vsrs(5, **kw), pad_to_rows=8,
                            device=CPU)
    jpad = jp.build_problem(jt, jvsr.random_vsrs(5, **kw), pad_to_rows=8)
    Xp = np.concatenate([X, np.zeros((3, tprob.V), np.int32)])
    per = tp.attribute_power(tpad, Xp, n_rows=5)
    np.testing.assert_allclose(per, jp.attribute_power(jpad, Xp, n_rows=5),
                               rtol=1e-5)
    np.testing.assert_allclose(per.sum(), float(tp.evaluate(tpad, Xp).total),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# resolve_incremental on the reference's streams
# ---------------------------------------------------------------------------

def _ref_streams(key, T, C, target, prob, el=None):
    """The reference's draws inside resolve_incremental
    (src/repro/core/solvers.py, phase 2): fi, p_prop, u_prop and the
    restart placements from ``split(key, 4)``."""
    P, R, V = prob.P, prob.R, prob.V
    kf, kp, ka, kx = jax.random.split(key, 4)
    fi = jax.random.randint(kf, (T, C), 0, target.shape[0])
    u = jax.random.uniform(ka, (T, C))
    if el is None:
        p = jax.random.randint(kp, (T, C), 0, P, jnp.int32)
        rand = jax.random.randint(kx, (C, R, V), 0, P, jnp.int32)
    else:
        _, cnt, cand = js._eligible_np(el)
        cnt, cand = jnp.asarray(cnt), jnp.asarray(cand)
        rows = jnp.asarray(target[:, 0])[fi]
        p = js._sample_eligible(jax.random.uniform(
            jax.random.fold_in(kp, 1), (T, C)), rows, cnt, cand)
        rand = js._sample_eligible(
            jax.random.uniform(jax.random.fold_in(kx, 1), (C, R, V)),
            jnp.arange(R)[None, :, None], cnt, cand)
    return tuple(np.asarray(a) for a in (fi, p, u, rand))


def _churn_pair(topos, sources, arrival: bool):
    """A warm 5-service placement (coordinate from CDC on the reference)
    carried into a grown problem (one arrival, row 5) or a shrunk one (row
    1 departs).  Returns (jprob, tprob, jstate, tstate, changed_rows)."""
    jt, tt = topos
    kw = dict(rng=31, source_nodes=sources)
    jbase, tbase = jvsr.random_vsrs(5, **kw), tvsr.random_vsrs(5, **kw)
    jprob0 = jp.build_problem(jt, jbase)
    cdc = jt.layer_indices("cdc")[0]
    warm = js.coordinate(jprob0, np.full((5, jprob0.V), cdc, np.int32)).X
    if arrival:
        nkw = dict(rng=500, source_nodes=sources[:1])
        jv = jbase.concat(jvsr.random_vsrs(1, **nkw))
        tv = tbase.concat(tvsr.random_vsrs(1, **nkw))
        jprob = jp.build_problem(jt, jv)
        tprob = tp.build_problem(tt, tv, device=CPU)
        return (jprob, tprob, jp.warm_state(jprob, warm),
                tp.warm_state(tprob, warm), [5])
    keep = [0, 2, 3, 4]
    cut = lambda v: type(v)(F=v.F[keep], H=v.H[keep], src=v.src[keep],
                            input_vm=v.input_vm[keep])
    jprob, tprob = (jp.build_problem(jt, cut(jbase)),
                    tp.build_problem(tt, cut(tbase), device=CPU))
    return (jprob, tprob, jp.warm_state(jprob, warm, row_map=keep),
            tp.warm_state(tprob, warm, row_map=keep), [])


def _targets(tprob, changed):
    free = tp.build_aux(tprob).free_pos.numpy()
    pos = free[np.isin(free[:, 0], changed)]
    return pos if pos.shape[0] else free


@pytest.mark.parametrize("arrival", [True, False], ids=["arrive", "depart"])
@pytest.mark.parametrize("scale", ["paper", "city"])
def test_resolve_incremental_on_reference_streams(scale, arrival, request):
    """One arrival (targeted sweeps + anneal over the new row) or one
    departure (anneal over every free VM, random restarts): on the
    reference's own draws the port lands within 5e-2 of the reference's
    objective, keeps pins and never worsens its warm start."""
    jprob, tprob, jst, tst, changed = _churn_pair(
        request.getfixturevalue(scale), SOURCES[scale], arrival)
    key = jax.random.PRNGKey(1)
    kw = dict(anneal_steps=200, anneal_chains=4, anneal_t0=5.0)
    want = js.resolve_incremental(jprob, key=key, changed_rows=changed,
                                  state=jst, **kw)
    streams = _ref_streams(key, 200, 4, _targets(tprob, changed), tprob)
    got = ts.resolve_incremental(tprob, changed_rows=changed, state=tst,
                                 streams=streams, record_conv=True, **kw)
    assert got.method == want.method == "incremental"
    assert abs(got.objective - want.objective) <= 5e-2
    assert len(got.history) == len(want.history)
    fixed = tprob.fixed_mask.numpy()
    np.testing.assert_array_equal(got.X[fixed],
                                  tprob.fixed_node.numpy()[fixed])
    assert got.objective <= float(tp.objective(tprob, tst.X)) + 1e-3
    assert got.conv["best_obj"].shape == (200,)
    # the port's own generator: a valid re-solve, reproducible by seed
    a = ts.resolve_incremental(tprob, ts.default_generator(3),
                               changed_rows=changed, state=tst, **kw)
    b = ts.resolve_incremental(tprob, ts.default_generator(3),
                               changed_rows=changed, state=tst, **kw)
    np.testing.assert_array_equal(a.X, b.X)
    assert a.objective <= float(tp.objective(tprob, tst.X)) + 1e-3


@pytest.mark.parametrize("arrival", [True, False], ids=["arrive", "depart"])
@pytest.mark.parametrize("scale", ["paper", "city"])
def test_resolve_incremental_deterministic_matches_jax(scale, arrival,
                                                       request):
    """Without the anneal the re-solve is deterministic: the objective and
    the history equal the reference's (rtol 1e-5), also with the sweep
    list padded to a bucket."""
    jprob, tprob, jst, tst, changed = _churn_pair(
        request.getfixturevalue(scale), SOURCES[scale], arrival)
    for pad in (None, tprob.R * (tprob.V - 1) + 3):
        kw = dict(changed_rows=changed, anneal_steps=0,
                  pad_positions_to=pad, pad_changed_to=pad and 4)
        want = js.resolve_incremental(jprob, state=jst, **kw)
        got = ts.resolve_incremental(tprob, state=tst, **kw)
        assert got.objective == pytest.approx(want.objective, rel=1e-5)
        assert len(got.history) == len(want.history)
        np.testing.assert_allclose(got.history, want.history, rtol=1e-5)
    with pytest.raises(ValueError, match="prev_X or state"):
        ts.resolve_incremental(tprob)
    # prev_X alone builds the state: the same result
    via_x = ts.resolve_incremental(tprob, tst.X.numpy(), anneal_steps=0,
                                   changed_rows=changed)
    same = ts.resolve_incremental(tprob, state=tst, anneal_steps=0,
                                  changed_rows=changed)
    np.testing.assert_array_equal(via_x.X, same.X)


@pytest.mark.parametrize("scale", ["paper", "city"])
def test_resolve_incremental_max_hops(scale, request):
    """spec.max_hops=2 masks every phase: from a warm start that violates
    the radius (every free VM at the CDC), on the reference's masked
    streams, every VM ends within 2 hops of its source, and the
    objective is within 5e-2 of the reference's."""
    jt, tt = request.getfixturevalue(scale)
    src = SOURCES[scale]
    jprob, tprob = _problems((jt, tt), 5, 41, src)
    cdc = tt.layer_indices("cdc")[0]
    X0 = np.full((tprob.R, tprob.V), cdc, np.int32)
    tspec = TSpec(max_hops=2, anneal_steps=150, anneal_chains=4)
    el = tspec.masks(tprob)
    np.testing.assert_array_equal(el, JSpec(max_hops=2).masks(jprob))
    key = jax.random.PRNGKey(5)
    want = js.resolve_incremental(jprob, X0, key=key, changed_rows=[4],
                                  spec=JSpec(max_hops=2, anneal_steps=150,
                                             anneal_chains=4))
    streams = _ref_streams(key, 150, 4, _targets(tprob, [4]), tprob, el=el)
    got = ts.resolve_incremental(tprob, X0, changed_rows=[4], spec=tspec,
                                 streams=streams)
    own = ts.resolve_incremental(tprob, X0, ts.default_generator(0),
                                 changed_rows=[4], spec=tspec)
    assert abs(got.objective - want.objective) <= 5e-2
    src_of = tprob.fixed_node.numpy()[:, 0]        # the input VM's node
    for res in (got, own):
        for r in range(tprob.R):
            assert np.all(tt.path_hops[src_of[r], res.X[r]] <= 2), r


# ---------------------------------------------------------------------------
# the online engine
# ---------------------------------------------------------------------------

DET = dict(method="coordinate", anneal_steps=0, defrag_every=0)


def _engines(paper, **spec_kw):
    jt, tt = paper
    jeng = jdyn.OnlineEmbedder(jt, spec=JSpec(**spec_kw))
    teng = tdyn.OnlineEmbedder(tt, spec=TSpec(**spec_kw), device=CPU)
    return jeng, teng


def _assert_same_stats(got, want):
    assert [s.event for s in got] == [s.event for s in want]
    assert [s.method for s in got] == [s.method for s in want]
    assert [s.n_live for s in got] == [s.n_live for s in want]
    np.testing.assert_allclose([s.objective for s in got],
                               [s.objective for s in want], rtol=1e-5)
    np.testing.assert_allclose([s.power_w for s in got],
                               [s.power_w for s in want], rtol=1e-5)


def test_engine_deterministic_matches_jax(paper):
    """bootstrap -> add -> remove -> defrag, then a churn_trace replay,
    with a deterministic spec (coordinate, no anneal): the reference's
    event kinds, methods, sids and per-event objectives (rtol 1e-5)."""
    jeng, teng = _engines(paper, **DET)
    jeng.bootstrap(_jservices(4))
    teng.bootstrap(_services(4))
    jeng.add(_jservices(1, seed0=900)[0])
    teng.add(_services(1, seed0=900)[0])
    jeng.remove(jeng.sids[1])
    teng.remove(teng.sids[1])
    jeng.defrag()
    teng.defrag()
    # departures among sids 0..5, of which 1 and 5 are not live: replay
    # skips those; arrivals from sid 6 on
    events = tdyn.churn_trace(6, 6, rng=2)[6:]
    jevents = jdyn.churn_trace(6, 6, rng=2)[6:]
    jdyn.replay(jeng, jevents, lambda sid: jvsr.random_vsrs(
        1, rng=800 + sid, source_nodes=[0]))
    tdyn.replay(teng, events, lambda sid: tvsr.random_vsrs(
        1, rng=800 + sid, source_nodes=[0]))
    assert teng.sids == jeng.sids
    assert teng.admission == jeng.admission
    _assert_same_stats(teng.stats, jeng.stats)
    assert [s.event for s in teng.stats][:4] == ["bootstrap", "add",
                                                "remove", "defrag"]
    assert (teng.problem.R, teng.problem.V) == (jeng.problem.R,
                                                jeng.problem.V)


def test_engine_default_spec_event_loop(paper):
    """The default spec (cfn-milp, 600-step anneal): bootstrap -> add ->
    remove -> defrag keeps a state consistent with a fresh evaluation,
    per-service watts sum to the total, and the objective after the
    removal is within 10% of a from-scratch solve_cfn."""
    _, tt = paper
    eng = tdyn.OnlineEmbedder(tt, spec=TSpec(defrag_every=0), device=CPU)
    eng.bootstrap(_services(4))
    assert eng.n_live == 4 and eng.result.method.startswith("cfn-milp")
    eng.add(_services(1, seed0=900)[0])
    assert eng.n_live == 5 and eng.result.method == "incremental"
    fresh = tp.init_state(eng.problem, eng.X)
    assert abs(eng.objective() - float(fresh.obj)) <= \
        1e-3 + 1e-6 * abs(float(fresh.obj))
    per = eng.per_service_power_w()
    assert set(per) == set(eng.sids)
    np.testing.assert_allclose(sum(per.values()), eng.power_w(),
                               rtol=1e-5, atol=1e-3)
    eng.remove(eng.sids[1])
    assert eng.n_live == 4
    with pytest.warns(DeprecationWarning):
        scratch = ts.solve_cfn(eng.problem, tt, ts.default_generator(9))
    assert eng.objective() <= scratch.objective * 1.10
    before = eng.objective()
    eng.defrag()
    assert eng.objective() <= before + 1e-6
    assert [s.event for s in eng.stats] == ["bootstrap", "add", "remove",
                                           "defrag"]


def test_engine_admission_rejects_and_rolls_back(paper):
    """A tight power budget rejects arrivals: the engine rolls back to
    its state before the arrival, and the admission counters, sids and
    events equal the reference's."""
    spec = dict(DET, power_budget_w=10.0, max_hops=4)
    jeng, teng = _engines(paper, **spec)
    for k, (js_, ts_) in enumerate(zip(_jservices(5, seed0=60),
                                       _services(5, seed0=60))):
        X0, obj0, sids0 = teng.X, teng.objective(), teng.sids
        jr = jeng.add(js_)
        tr = teng.add(ts_)
        assert (jr is None) == (tr is None), k
        if tr is None:
            assert teng.sids == sids0
            np.testing.assert_array_equal(teng.X, X0)
            assert teng.objective() == obj0 or (np.isnan(obj0)
                                                and np.isnan(
                                                    teng.objective()))
    assert teng.admission == jeng.admission
    assert teng.admission["rejected"] > 0 and teng.admission["admitted"] > 0
    assert teng.sids == jeng.sids
    _assert_same_stats(teng.stats, jeng.stats)


def test_positional_constraints_refused_by_churn(paper):
    """Sequence max_hops / explicit eligible bind to batch rows: churn
    refuses them, the static batch path takes them."""
    _, tt = paper
    vs = tvsr.random_vsrs(2, rng=3, source_nodes=[0])
    ses = CFNSession(tt, TSpec(max_hops=[1, 5], method="coordinate",
                               bucket_rows=False, bucket_cols=False),
                     device=CPU)
    res = ses.solve(vs)
    for r, mh in enumerate([1, 5]):
        assert all(tt.path_hops[0, p] <= mh for p in res.X[r])
    with pytest.raises(ValueError, match="row-positional"):
        ses.remove(ses.sids[0])
    with pytest.raises(ValueError, match="row-positional"):
        ses.add(tvsr.random_vsrs(1, rng=9, source_nodes=[0]))
    ses2 = CFNSession(tt, TSpec(eligible=np.ones((1, tt.P), bool)),
                      device=CPU)
    with pytest.raises(ValueError, match="row-positional"):
        ses2.add(tvsr.random_vsrs(1, rng=9, source_nodes=[0]))


def test_column_buckets_and_service_vms(paper):
    """Mixing 3-, 5- and 4-VM services keeps V on power-of-two buckets,
    the reference's; service_vms keeps each service's own width; the
    committed state is a fresh build's."""
    _, tt = paper
    ses = CFNSession(tt, TSpec(defrag_every=0, anneal_steps=60,
                               anneal_chains=4, polish_sweeps=1),
                     generator=ts.default_generator(4), device=CPU)
    shapes = []
    for sid, n in enumerate((3, 3, 5, 4)):
        ses.add(tvsr.random_vsrs(1, rng=600 + sid, n_vms=n,
                                 source_nodes=[0]), sid=sid)
        shapes.append((ses.problem.R, ses.problem.V))
    assert shapes == [(2, 4), (2, 4), (4, 8), (4, 8)]
    fresh = tp.init_state(ses.problem, ses.X)
    assert abs(float(fresh.obj) - ses.objective()) <= \
        1e-3 + 1e-6 * abs(float(fresh.obj))
    per = ses.attribute()
    assert abs(sum(per.values()) - ses.power_w()) <= \
        1e-6 * max(1.0, ses.power_w())
    assert [ses.service_vms(r) for r in range(4)] == [3, 3, 5, 4]
    ses.remove(2)                       # the 5-VM service departs
    assert ses.problem.V == 8           # the width is kept
    assert [ses.service_vms(r) for r in range(3)] == [3, 3, 4]


def test_bootstrap_adopts_X0_like_jax(paper):
    """bootstrap(X0=...) commits the exact evaluation of an adopted
    placement: pins applied, missing columns and pad rows at each row's
    source -- the reference's placement and objective."""
    jeng, teng = _engines(paper, **DET)
    X0 = np.random.default_rng(2).integers(0, 23, (3, 2)).astype(np.int32)
    want = jeng.bootstrap(_jservices(3), X0=X0)
    got = teng.bootstrap(_services(3), X0=X0)
    assert got.method == want.method == "bootstrap(adopted)"
    np.testing.assert_array_equal(got.X, want.X)
    assert got.objective == pytest.approx(want.objective, rel=1e-5)
    assert teng.stats[-1].event == "bootstrap"
    with pytest.raises(RuntimeError):
        teng.bootstrap(_services(1))


def test_engine_rejects_bad_inputs(paper):
    _, tt = paper
    sc = tdyn.SCENARIOS["steady"]
    eng = tdyn.OnlineEmbedder(tt, spec=TSpec(**DET), device=CPU)
    with pytest.raises(ValueError):
        TSpec(method="nope")
    with pytest.raises(ValueError):
        eng.bootstrap([])
    with pytest.raises(ValueError):
        eng.bootstrap([sc.sample_vsr(0)], sids=[1, 2])
    with pytest.raises(ValueError):
        eng.add(tvsr.random_vsrs(2, rng=0))
    eng.add(sc.sample_vsr(0), sid=5)
    with pytest.raises(ValueError):      # sid already live
        eng.add(sc.sample_vsr(1), sid=5)
    assert eng.sids == [5]
    eng.add(sc.sample_vsr(1), sid=6)
    assert eng.sids == [5, 6]
    # draining the engine empties it, and it is reusable
    assert eng.remove(5) is not None
    assert eng.remove(6) is None and eng.n_live == 0 and eng.power_w() == 0
    assert eng.defrag() is None
    eng.add(sc.sample_vsr(2))
    assert eng.sids == [7] and eng.objective() > 0


def test_deprecated_kwargs_and_clone(paper):
    """The legacy kwarg signature warns and builds the equivalent spec; its
    aliases read and write through the spec; a clone is detached."""
    _, tt = paper
    with pytest.warns(DeprecationWarning):
        eng = tdyn.OnlineEmbedder(tt, defrag_every=3, max_hops=2,
                                  admit_power_budget_w=50.0, device=CPU)
    assert eng.spec.defrag_every == 3 and eng.spec.power_budget_w == 50.0
    eng.defrag_every = 5
    assert eng.spec.defrag_every == 5 and eng.max_hops == 2
    with pytest.raises(ValueError):
        with pytest.warns(DeprecationWarning):
            tdyn.OnlineEmbedder(tt, method="nope", device=CPU)
    det = tdyn.OnlineEmbedder(tt, spec=TSpec(**DET), device=CPU)
    det.bootstrap(_services(2))
    twin = det.clone()
    twin.add(_services(1, seed0=7)[0])
    assert det.n_live == 2 and twin.n_live == 3
    assert len(det.stats) == 1 and len(twin.stats) == 2


# ---------------------------------------------------------------------------
# timelines and replay
# ---------------------------------------------------------------------------

def _events(ev):
    return [(e.t, e.kind, e.sid) for e in ev]


def test_timelines_byte_equal_to_jax():
    t = np.arange(0.0, 48.0, 0.25)
    assert tdyn.diurnal_rate(t, 1.0, 5.0, 20.0).tobytes() == \
        jdyn.diurnal_rate(t, 1.0, 5.0, 20.0).tobytes()
    assert _events(tdyn.poisson_timeline(24.0, lambda x: 3.0, 2.0, rng=0)) \
        == _events(jdyn.poisson_timeline(24.0, lambda x: 3.0, 2.0, rng=0))
    assert _events(tdyn.poisson_timeline(24.0, lambda x: 9.0, 5.0, rng=4,
                                         max_services=7)) == \
        _events(jdyn.poisson_timeline(24.0, lambda x: 9.0, 5.0, rng=4,
                                      max_services=7))
    for n, m, seed in ((4, 6, 0), (64, 8, 0), (3, 4, 1)):
        assert _events(tdyn.churn_trace(n, m, rng=seed)) == \
            _events(jdyn.churn_trace(n, m, rng=seed))
    assert set(tdyn.SCENARIOS) == set(jdyn.SCENARIOS)
    for name, sc in tdyn.SCENARIOS.items():
        ref = jdyn.SCENARIOS[name]
        assert _events(sc.timeline(3)) == _events(ref.timeline(3))
        assert sc.rate_fn()(7.5) == ref.rate_fn()(7.5)
        for seed in (0, 11):
            a, b = sc.sample_vsr(seed), ref.sample_vsr(seed)
            for f in ("F", "H", "src", "input_vm"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
            assert a.R == 1 and a.V == sc.n_vms


def test_replay_skips_unmaterialized_departures(paper):
    _, tt = paper
    sc = tdyn.SCENARIOS["steady"]
    events = [tdyn.ServiceEvent(0.0, "arrive", 0),
              tdyn.ServiceEvent(0.5, "depart", 99),   # never arrived
              tdyn.ServiceEvent(1.0, "arrive", 1),
              tdyn.ServiceEvent(2.0, "depart", 0)]
    eng = tdyn.OnlineEmbedder(tt, spec=TSpec(defrag_every=0), device=CPU)
    seen = []
    stats = tdyn.replay(eng, events, lambda sid: sc.sample_vsr(sid),
                        on_event=lambda ev, res: seen.append(
                            (ev.sid, res is None)))
    assert eng.n_live == 1 and eng.sids == [1]
    assert [s.event for s in stats] == ["add", "add", "remove"]
    assert seen == [(0, False), (99, True), (1, False), (0, False)]
    assert eng._now == 2.0


def test_replay_departs_bootstrapped_services(paper):
    """Departures of services admitted via bootstrap() (not by this replay)
    are executed."""
    _, tt = paper
    sc = tdyn.SCENARIOS["steady"]
    eng = tdyn.OnlineEmbedder(tt, spec=TSpec(defrag_every=0), device=CPU)
    eng.bootstrap([sc.sample_vsr(0), sc.sample_vsr(1)], sids=[10, 11])
    events = [tdyn.ServiceEvent(1.0, "depart", 10),
              tdyn.ServiceEvent(2.0, "arrive", 12)]
    tdyn.replay(eng, events, lambda sid: sc.sample_vsr(sid))
    assert eng.n_live == 2 and set(eng.sids) == {11, 12}


@pytest.mark.parametrize("max_hops", [None, 2])
def test_session_replay_matches_deprecated_engine(paper, max_hops):
    """The same churn trace through CFNSession.replay and through the
    deprecated kwarg engine: identical placements, power, admission
    counters and events; a defrag ran; the objective is the float64
    oracle's; with max_hops every VM stays in its radius."""
    _, tt = paper
    events = tdyn.churn_trace(3, 4, rng=1)
    make = lambda sid: tvsr.random_vsrs(1, rng=700 + sid, source_nodes=[0])
    with pytest.warns(DeprecationWarning):
        eng = tdyn.OnlineEmbedder(tt, defrag_every=3, anneal_steps=60,
                                  anneal_chains=4, polish_sweeps=1,
                                  max_hops=max_hops,
                                  generator=ts.default_generator(7),
                                  device=CPU)
    legacy = tdyn.replay(eng, events, make)
    spec = TSpec(defrag_every=3, anneal_steps=60, anneal_chains=4,
                 polish_sweeps=1, max_hops=max_hops)
    ses = CFNSession(tt, spec, generator=ts.default_generator(7),
                     device=CPU)
    got = ses.replay(events, make)
    assert eng.sids == ses.sids
    np.testing.assert_array_equal(eng.X, ses.X)
    assert eng.power_w() == ses.power_w()
    assert eng.admission == ses.admission
    assert [(s.event, s.method, s.objective) for s in legacy] == \
        [(s.event, s.method, s.objective) for s in got]
    want = tref.placement_objective_f64(ses.problem, ses.X)
    assert abs(ses.objective() - want) <= 5e-2 + 1e-5 * abs(want)
    assert any(s.method.startswith(("cfn-milp", "defrag-kept"))
               for s in got), [s.method for s in got]
    if max_hops is not None:
        for row in range(ses.n_live):
            assert all(tt.path_hops[0, p] <= max_hops for p in ses.X[row])


# ---------------------------------------------------------------------------
# the spec options of the queue / priority / defrag-tick plane at churn, and
# fault timelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option", [dict(queue_rejected=True),
                                    dict(priority_classes=2),
                                    dict(preempt=True, priority_classes=2),
                                    dict(defrag_rows_per_tick=1)],
                         ids=["queue", "priority", "preempt", "defrag_tick"])
def test_churn_options_match_jax(paper, option):
    """Each option of the queue / priority / defrag-tick plane through
    solve(vsrs), a class-1 arrival, a class-0 arrival under a zero-watt
    brownout, a departure, brownout_end and a defrag tick: the reference's
    placements, objectives, sids, queue, classes and counters after every
    step."""
    jt, tt = paper
    spec = dict(DET, **option)
    jses = JSession(jt, JSpec(**spec), key=jax.random.PRNGKey(7))
    tses = CFNSession(tt, TSpec(**spec), device=CPU)
    low = 1 if option.get("priority_classes", 1) > 1 else None

    def both(fn):
        got = [fn(ses, mod) for ses, mod in ((jses, jvsr), (tses, tvsr))]
        j, t = jses.engine, tses.engine
        np.testing.assert_array_equal(t.X, np.asarray(j.X))
        assert t.objective() == pytest.approx(j.objective(), rel=1e-5,
                                              abs=5e-2)
        assert (t.sids, t.queued_sids, t._prio, t.admission) == \
            (j.sids, j.queued_sids, j._prio, j.admission)
        assert [s.event for s in t.stats] == [s.event for s in j.stats]
        return got

    res = both(lambda ses, m: ses.solve(m.random_vsrs(3, rng=0,
                                                      source_nodes=[0])))
    assert res[1].method == "coordinate"
    both(lambda ses, m: ses.add(m.random_vsrs(1, rng=1, source_nodes=[0]),
                                sid=10, priority=low))
    both(lambda ses, m: ses.engine.brownout(0.0))
    got = both(lambda ses, m: ses.add(m.random_vsrs(1, rng=2,
                                                    source_nodes=[0]),
                                      sid=11, priority=0))
    assert got == [None, None]
    both(lambda ses, m: ses.remove(ses.sids[0]))
    both(lambda ses, m: ses.engine.brownout_end())
    ticks = both(lambda ses, m: ses.engine.defrag_tick())
    assert (ticks[0] is None) == (ticks[1] is None)
    adm = tses.admission
    if option.get("queue_rejected"):
        assert adm["queued"] == 1 and 11 in tses.sids
    if option.get("preempt"):
        assert adm["preempted"] == 1 and 10 in tses.sids
    assert adm["rejected"] == 1


def test_unported_timelines_raise(paper):
    """A fault event in a timeline (a node failure, a brownout), once
    unported, now replays as in the JAX package in both modes: the same
    live sids, stats, admission counters and health.  A region fault
    (federation, ROADMAP Queue 1 item 6) raises in both packages, after
    the events before it."""
    jt, tt = paper
    for waves in (False, True):
        got = []
        for pkg, dyn, ses in (
                (jvsr, jdyn, JSession(jt, JSpec(**DET),
                                      key=jax.random.PRNGKey(7))),
                (tvsr, tdyn, CFNSession(tt, TSpec(**DET), device=CPU))):
            make = lambda sid, pkg=pkg: pkg.random_vsrs(1, rng=sid,
                                                        source_nodes=[0])
            storm = dyn.merge_timelines(dyn.churn_trace(2, 2, rng=0), [
                dyn.FaultEvent(0.5, "fail_node", 3),
                dyn.FaultEvent(0.5, "brownout", value=1e5),
                dyn.FaultEvent(1.5, "recover_node", 3)])
            ses.replay(storm, make, waves=waves)
            got.append((ses.sids, ses.admission,
                        [(s.event, s.method, s.n_live) for s in ses.stats],
                        [s.objective for s in ses.stats],
                        ses.health.node_up.tolist(), ses.spec.power_budget_w))
            with pytest.raises(ValueError, match="region"):
                ses.replay([dyn.ServiceEvent(3.0, "arrive", 9),
                            dyn.FaultEvent(3.5, "fail_region", 0)], make,
                           waves=waves)
            assert 9 in ses.sids
        (js_, ja, jst, jobj, jh, jb), (ts_, ta, tst, tobj, th, tb) = got
        assert (ts_, ta, tst, th, tb) == (js_, ja, jst, jh, jb)
        np.testing.assert_allclose(tobj, jobj, rtol=1e-5, atol=5e-2)
        assert "fail_node" in [e for e, _, _ in tst] and tb == 1e5
