"""Federation of the PyTorch port against the JAX package, on the CPU (the
template is ``tests/test_federation.py``).

The reference's small fixture ``federated_scale(3, n_olt=1,
onus_per_olt=2, iot_per_onu=2, n_core=6)`` (P_r = 7, the dense-route
branch) and, for the CSR branch, ``federated_scale(2, n_olt=4,
onus_per_olt=4, iot_per_onu=4)`` (P_r = 70).  Inputs are numpy arrays
made from seeds, passed through both packages:

  * the partition's arrays (membership, local ids, core hops, each
    region's route table, the padded substrates) byte-equal;
  * ``federated_breakdown`` equal to the reference's (rtol 1e-12);
  * ``solve_portfolio_batched`` on the reference's own ``jax.random``
    streams: placements equal, objectives rtol 1e-5 -- where a float32
    tie breaks the other way (two regions of the dense case: twin nodes of
    one objective, and a Metropolis path that parts at an accept test) the
    two placements' float64 oracle objectives agree to rtol 1e-5 instead;
  * the batched (lockstep, vmapped) solve equal to its plain version, the
    per-region loop, and its delta-engine call count independent of G
    (the port's counterpart of the reference's single-compile check);
  * sessions under the deterministic spec (cfn-milp "quick", no engine
    anneal, no periodic defrag) equal call for call: placements,
    assignments, sids, the fault queue, the engines' objectives (rtol
    1e-5 / atol 5e-2) and the exact fleet watts (rtol 1e-12);
  * the reference test's own cases under its own (stochastic) specs,
    held to its invariants: conservation, the float64 oracle (1e-7
    relative), affinity, budgets, migrations, the monitor.

Region faults and the monitor roll-up are in
``tests/test_torch_federation_faults.py``."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import FederatedSession as JFed, PlacementSpec as JSpec
from repro.core import dynamic as jdyn, federation as jfed, \
    power as jp, solvers as js, topology as jtopo, vsr as jvsr
from repro.fault.monitor import PlacementMonitor as JMonitor
from repro_torch.api import (CFNSession as TSession, FederatedSession as TFed,
                             PlacementSpec as TSpec, RegionPartition)
from repro_torch.core import dynamic as tdyn, federation as tfed, \
    power as tp, solvers as ts, topology as ttopo, vsr as tvsr
from repro_torch.fault import PlacementMonitor as TMonitor
from repro_torch.kernels import ref as tref

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
FED = dict(n_regions=3, n_olt=1, onus_per_olt=2, iot_per_onu=2, n_core=6)
CSR = dict(n_regions=2, n_olt=4, onus_per_olt=4, iot_per_onu=4)
QUICK = dict(effort="quick", anneal_steps=0, defrag_every=0)
OBJ_TOL = dict(rtol=1e-5, atol=5e-2)


def _fed(**kw):
    jt, tt = jtopo.federated_scale(**kw), ttopo.federated_scale(**kw)
    return (jt, tt, jfed.RegionPartition.from_topology(jt),
            tfed.RegionPartition.from_topology(tt))


@pytest.fixture(scope="module")
def fed():
    return _fed(**FED)


def _srcs(part):
    return [int(r.proc_ids[0]) for r in part.regions]


def _svc(pkg, seed, src, n=1):
    """n services from numpy seed ``seed`` at source ``src`` (a node or a
    list of nodes), in ``pkg``'s vsr module."""
    src = src if isinstance(src, list) else [src]
    return pkg.random_vsrs(n, rng=seed, source_nodes=src)


def _oracle_gap(topo, vsrs, X, objective):
    prob = tp.build_problem(topo, vsrs, device=CPU)
    X = np.asarray(X)[:vsrs.R, :vsrs.V]   # strip bucket padding
    oracle = tref.placement_objective_f64(prob, X)
    return abs(oracle - objective), oracle


def _chain(svcs):
    return tvsr.concat_all(list(svcs))


def _conserved(bd):
    assert abs(bd.regional_w.sum() + bd.inter_region_w - bd.total_w) \
        <= 1e-9 * max(1.0, bd.total_w)


class FedTwin:
    """A JAX and a port ``FederatedSession`` fed the same calls (services
    by seed and source); ``check`` holds them equal."""

    def __init__(self, topos, spec_kw, monitors=False):
        self.jt, self.tt = topos
        self.jm = JMonitor() if monitors else None
        self.tm = TMonitor() if monitors else None
        self.j = JFed(self.jt, JSpec(**spec_kw), key=jax.random.PRNGKey(3),
                      monitor=self.jm)
        self.t = TFed(self.tt, TSpec(**spec_kw), device=CPU, monitor=self.tm)

    def svc(self, seed, src):
        return _svc(jvsr, seed, src), _svc(tvsr, seed, src)

    def add(self, seed, src, **kw):
        jsv, tsv = self.svc(seed, src)
        jr, tr = self.j.add(jsv, **kw), self.t.add(tsv, **kw)
        assert (jr is None) == (tr is None)
        self.check()
        return tr

    def do(self, name, *args):
        jr, tr = getattr(self.j, name)(*args), getattr(self.t, name)(*args)
        if isinstance(jr, (int, type(None))):
            assert tr == jr
        self.check()
        return tr

    def check(self):
        j, t = self.j, self.t
        assert t.sids == j.sids
        if j.X is None:
            assert t.X is None
        else:
            np.testing.assert_array_equal(t.X, np.asarray(j.X))
            jb, tb = j.breakdown(), t.breakdown()
            np.testing.assert_allclose(tb.total_w, jb.total_w, rtol=1e-12)
            np.testing.assert_allclose(tb.regional_w, jb.regional_w,
                                       rtol=1e-12, atol=1e-9)
            np.testing.assert_allclose(tb.inter_region_w, jb.inter_region_w,
                                       rtol=1e-12, atol=1e-9)
            _conserved(tb)
        for sid in j.sids:
            assert t.assignment(sid) == j.assignment(sid)
        assert t.down_regions == j.down_regions
        assert [e[1:] for e in t._fqueue] == [e[1:] for e in j._fqueue]
        assert sorted(t._engines) == sorted(j._engines)
        for g, je in j._engines.items():
            te = t._engines[g]
            assert te.sids == je.sids and te.queued_sids == je.queued_sids
            if je.X is not None:
                np.testing.assert_allclose(te.objective(), je.objective(),
                                           **OBJ_TOL)
        if self.jm is not None:
            assert self.tm.counters == self.jm.counters
            assert self.tm.events == self.jm.events
            assert self.tm.stranded_since == self.jm.stranded_since
            assert self.tm.stranded_service_s == pytest.approx(
                self.jm.stranded_service_s, abs=1e-12)


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------

def test_partition_structure(fed):
    _, tt, _, tpart = fed
    assert tpart.G == 3
    assert sorted(np.concatenate([r.proc_ids for r in tpart.regions])
                  .tolist()) == list(range(tt.P))
    assert len(tpart.core_net_ids) == 6
    assert all(tt.net_names[n].startswith("nsf")
               for n in tpart.core_net_ids)
    assert np.array_equal(tpart.core_hops, tpart.core_hops.T)
    assert np.all(np.diag(tpart.core_hops) == 0)
    off = tpart.core_hops[~np.eye(tpart.G, dtype=bool)]
    assert np.all(off > 0)


@pytest.mark.parametrize("kw", [FED, CSR], ids=["dense", "csr"])
def test_partition_arrays_byte_equal_to_jax(kw):
    _, _, jpart, tpart = _fed(**kw)
    for name in ("proc_region", "net_region", "core_net_ids", "_proc_local",
                 "core_hops"):
        a, b = getattr(tpart, name), np.asarray(getattr(jpart, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for jr, tr in zip(jpart.regions, tpart.regions):
        assert (tr.index, tr.name, tr.pin_node) == \
            (jr.index, jr.name, jr.pin_node)
        np.testing.assert_array_equal(tr.proc_ids, jr.proc_ids)
        np.testing.assert_array_equal(tr.net_ids, jr.net_ids)
        assert tr.topo.proc_names == jr.topo.proc_names
        np.testing.assert_array_equal(tr.topo.route_idx,
                                      np.asarray(jr.topo.route_idx))
    jsubs, jmasks, jshape = jpart.padded_substrates()
    tsubs, tmasks, tshape = tpart.padded_substrates(CPU)
    assert tshape == jshape
    for jd, td, jm, tm in zip(jsubs, tsubs, jmasks, tmasks):
        np.testing.assert_array_equal(tm, jm)
        assert set(td) == set(jd)
        for k, v in jd.items():
            if v is None:
                assert td[k] is None, k
            else:
                got = td[k].numpy()
                assert got.dtype == np.asarray(v).dtype, k
                np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    # built once per device
    assert tpart.padded_substrates(CPU)[0] is tsubs


def test_region_routes_match_merged(fed):
    _, tt, _, tpart = fed
    rt_merged = np.asarray(tt.route_idx)
    for reg in tpart.regions:
        lut = np.full(tt.N + 1, reg.N, np.int64)
        lut[reg.net_ids] = np.arange(reg.N)
        mapped = lut[rt_merged[np.ix_(reg.proc_ids, reg.proc_ids)]]
        local = np.asarray(reg.topo.route_idx)
        K = max(mapped.shape[2], local.shape[2])
        pad = lambda a: np.concatenate(
            [a, np.full(a.shape[:2] + (K - a.shape[2],), reg.N, a.dtype)],
            axis=2)
        np.testing.assert_array_equal(pad(mapped), pad(local))


def test_partition_single_identity(fed):
    _, tt, _, _ = fed
    part = tfed.RegionPartition.single(tt)
    assert part.G == 1 and part.regions[0].topo is tt
    np.testing.assert_array_equal(part.regions[0].proc_ids,
                                  np.arange(tt.P))
    flat = ttopo.paper_topology()
    assert tfed.RegionPartition.from_topology(flat).G == 1


def test_exports_and_solver_aliases():
    assert RegionPartition is tfed.RegionPartition
    for name in ts._FEDERATION_MOVED:
        assert getattr(ts, name) is getattr(tfed, name)
    with pytest.raises(AttributeError):
        ts.not_a_solver


def test_device_default_and_telemetry_refused(fed):
    """Without ``device=`` the session runs on the CUDA card and raises
    without one; ``telemetry=`` is taken (no longer refused): the
    coordinator spans its calls and takes a fleet-exact ledger sample."""
    _, tt, _, tpart = fed
    import torch
    from repro_torch.telemetry import Telemetry
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TFed(tt, TSpec(**QUICK))
    tel = Telemetry()
    sess = TFed(tt, TSpec(**QUICK), device=CPU)
    sess.attach_telemetry(tel)
    assert sess.telemetry is tel and tel.ledger.tiers is not None
    sess.solve(_svc(tvsr, 2, _srcs(tpart), n=3))
    assert [e["name"] for e in tel.events if e["type"] == "span"] == \
        ["federated_solve"]
    (sample,) = tel.ledger.samples
    assert sample["total_w"] == pytest.approx(sess.power_w(), rel=1e-12)
    assert sum(sample["region_w"].values()) == pytest.approx(
        sample["total_w"], rel=1e-9)


# ---------------------------------------------------------------------------
# exact accounting
# ---------------------------------------------------------------------------

def test_federated_breakdown_equals_jax(fed):
    """The same regional states and cut links through both packages'
    ``federated_breakdown``: every field equal to rtol 1e-12."""
    jt, tt, jpart, tpart = fed
    srcs = _srcs(tpart)
    jstates, tstates = [], []
    rng = np.random.default_rng(4)
    for g, reg in enumerate(tpart.regions):
        jvs = _svc(jvsr, 10 + g, 0, n=3)
        tvs = _svc(tvsr, 10 + g, 0, n=3)
        jprob = jp.build_problem(jpart.regions[g].topo, jvs)
        tprob = tp.build_problem(reg.topo, tvs, device=CPU)
        X = rng.integers(0, reg.P, size=(3, tvs.V)).astype(np.int32)
        jstates.append((g, jprob, X))
        tstates.append((g, tprob, X))
    cuts = [(12.5, srcs[0], srcs[1] + 2, True), (7.0, srcs[2], srcs[0] + 1,
                                                  False)]
    want = jfed.federated_breakdown(jpart, jstates, cuts=cuts)
    got = tfed.federated_breakdown(tpart, tstates, cuts=cuts)
    for name in ("total_w", "inter_region_w", "violation"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, err_msg=name)
    for name in ("regional_w", "per_proc_w", "per_net_w"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    assert got.inter_region_w > 0.0
    _conserved(got)


@pytest.mark.parametrize("make", [
    ttopo.paper_topology,
    lambda: ttopo.city_scale(n_olt=2, onus_per_olt=2, iot_per_onu=2),
    lambda: ttopo.federated_scale(**FED)], ids=["paper", "city", "fed"])
def test_link_oracle_equals_dense_oracle(make):
    """``ref.placement_objective_f64_links`` (the float64 oracle phase 3g
    runs on the merged P = 1864 substrate) is ``placement_objective_f64``
    on random placements with padded rows and columns."""
    topo = make()
    for seed in range(3):
        vs = tvsr.random_vsrs(7, rng=seed,
                              source_nodes=topo.layer_indices("iot")[:3])
        prob = tp.build_problem(topo, vs, device=CPU, pad_to_rows=8,
                                pad_to_cols=4)
        X = np.random.default_rng(seed).integers(0, topo.P, (8, 4))
        want = tref.placement_objective_f64(prob, X.astype(np.int32))
        got = tref.placement_objective_f64_links(prob, X.astype(np.int32))
        assert got == pytest.approx(want, rel=1e-12)


def test_breakdown_reads_host_arrays(fed, monkeypatch):
    """``_loads_f64`` reads ``problem.host``, never a device tensor."""
    _, tt, _, tpart = fed
    reg = tpart.regions[0]
    prob = tp.build_problem(reg.topo, _svc(tvsr, 1, 0, n=2), device=CPU)
    X = np.zeros((prob.R, prob.V), np.int32)
    want = tfed._loads_f64(prob, X)
    monkeypatch.setattr(type(prob.route_idx), "numpy",
                        lambda *a, **k: pytest.fail("device tensor read"))
    monkeypatch.setattr(type(prob.route_idx), "cpu",
                        lambda *a, **k: pytest.fail("device tensor read"))
    got = tfed._loads_f64(prob, X)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the region-batched portfolio
# ---------------------------------------------------------------------------

def _decomposed(kw, n, seed, effort):
    """Both packages' ``_decompose`` of n services (sources round-robin
    over the regions' first nodes) under ``effort``."""
    jt, tt, jpart, tpart = _fed(**kw)
    srcs = _srcs(tpart)
    jvs = jvsr.random_vsrs(n, rng=seed, source_nodes=srcs)
    tvs = tvsr.random_vsrs(n, rng=seed, source_nodes=srcs)
    j = JFed(jt, JSpec(effort=effort))
    t = TFed(tt, TSpec(effort=effort), device=CPU)
    split = lambda pkg, v: [pkg.VSRBatch(F=v.F[i:i + 1], H=v.H[i:i + 1],
                                         src=v.src[i:i + 1],
                                         input_vm=v.input_vm[i:i + 1])
                            for i in range(n)]
    assigned = j._assign(split(jvsr, jvs))
    _, jprobs, jels, jX0, _ = j._decompose(split(jvsr, jvs), list(range(n)),
                                           assigned)
    _, tprobs, tels, tX0, _ = t._decompose(split(tvsr, tvs), list(range(n)),
                                           assigned)
    return jprobs, jels, jX0, tprobs, tels, tX0


def _ref_batch_streams(jprobs, jels, effort, key):
    """The reference's draws inside ``solve_portfolio_batched``
    (src/repro/core/federation.py): per region, ``split(key, 3)``, the
    proposals of the link-padded problem's aux and the eligible restarts.
    Returns ``(j_prop, p_prop, u_prop, restarts)`` as numpy."""
    _, n_steps, n_chains = jfed._BATCH_EFFORT[effort]
    G = len(jprobs)
    R, V, P = jprobs[0].R, jprobs[0].V, jprobs[0].P
    L = js._pow2(max(int(p.link_src.shape[0]) for p in jprobs))
    probs = [jfed._pad_links(p, L) for p in jprobs]
    jpr = np.zeros((G, n_steps, n_chains), np.int32)
    ppr = np.zeros_like(jpr)
    upr = np.zeros(jpr.shape, np.float32)
    rand = np.zeros((G, n_chains, R, V), np.int32)
    for g, prob in enumerate(probs):
        aux = jp.build_aux(prob)
        key, kp, kr = jax.random.split(key, 3)
        _, cnt, cand = js._eligible_np(jels[g])
        fi, p_prop, u_prop = js._anneal_proposals(kp, aux, n_steps, n_chains,
                                                  P, V=V, cnt=cnt, cand=cand)
        jpr[g] = np.asarray(aux.free_flat[fi])
        ppr[g] = np.asarray(p_prop)
        upr[g] = np.asarray(u_prop)
        u_r = jax.random.uniform(kr, (n_chains, R, V))
        rand[g] = np.asarray(js._sample_eligible(
            u_r, jnp.arange(R)[None, :, None], jnp.asarray(cnt),
            jnp.asarray(cand)))
    return jpr, ppr, upr, rand


@pytest.mark.parametrize("kw,n,seed", [(FED, 6, 1), (CSR, 6, 1)],
                         ids=["dense_P7", "csr_P70"])
def test_batched_portfolio_on_reference_streams(kw, n, seed):
    """Effort "standard" (2 sweeps + 2000 x 8 Metropolis a region) on the
    reference's own draws: the port's batched solve lands on the
    reference's placements (objectives rtol 1e-5); a region whose float32
    tie broke the other way must agree on its float64 oracle objective
    instead.  Every VM stays on an eligible (real) node of its region."""
    jprobs, jels, jX0, tprobs, tels, tX0 = _decomposed(kw, n, seed,
                                                       "standard")
    key = jax.random.PRNGKey(5)
    streams = _ref_batch_streams(jprobs, jels, "standard", key)
    jX, jobj = jfed.solve_portfolio_batched(jprobs, jX0, jels,
                                            spec=JSpec(), key=key)
    tX, tobj = tfed.solve_portfolio_batched(tprobs, tX0, tels, spec=TSpec(),
                                            streams=streams)
    np.testing.assert_allclose(tobj, np.asarray(jobj), rtol=1e-5)
    n_equal = 0
    for g in range(len(tprobs)):
        assert tels[g][np.arange(tX.shape[1])[:, None], tX[g]].all()
        if np.array_equal(tX[g], np.asarray(jX[g])):
            n_equal += 1
            continue
        f_t = tref.placement_objective_f64(tprobs[g], tX[g])
        f_j = tref.placement_objective_f64(tprobs[g], np.asarray(jX[g]))
        assert f_t == pytest.approx(f_j, rel=1e-5)
    assert n_equal >= 1


@pytest.mark.parametrize("kw,effort", [(FED, "standard"), (CSR, "quick"),
                                       (CSR, "standard")],
                         ids=["dense_standard", "csr_quick", "csr_standard"])
def test_batched_solve_equals_per_region_loop(kw, effort):
    """The lockstep (vmapped) program and its plain version -- one region
    at a time through the single-problem functions -- on the same inputs
    give the same placements and objectives."""
    _, _, _, tprobs, tels, tX0 = _decomposed(kw, 5, 2, effort)
    args = tfed._batch_inputs(tprobs, tX0, tels, TSpec(effort=effort),
                              gen=ts.default_generator(9))
    bX, bobj = tfed._solve_regions(*args)
    lX, lobj = tfed._solve_regions_loop(*args)
    np.testing.assert_array_equal(bX.numpy(), lX.numpy())
    np.testing.assert_allclose(bobj.numpy(), lobj.numpy(), rtol=1e-6)
    for g, prob in enumerate(tprobs):
        f64 = tref.placement_objective_f64(prob, bX[g].numpy())
        assert abs(f64 - float(bobj[g])) <= 5e-2 + 1e-5 * abs(f64)


def test_batched_delta_calls_do_not_grow_with_g(monkeypatch):
    """One lockstep program: the number of ``_sweep_step`` / delta-sweep /
    chain-step calls in a batched solve is the same for 2 and 4 regions
    on one shape bucket (the reference traces once for any G)."""
    calls = {"delta_sweep": 0, "_chain_step": 0}
    for name in calls:
        fn = getattr(ts, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ts, name, counted)
    counts = []
    for G in (2, 4):
        _, tt, _, tpart = _fed(n_regions=G, n_olt=1, onus_per_olt=2,
                               iot_per_onu=2, n_core=4)
        srcs = _srcs(tpart)
        vs = tvsr.random_vsrs(2 * G, rng=0, source_nodes=srcs)
        vs.src[:] = np.repeat(srcs, 2)          # 2 services a region
        t = TFed(tt, TSpec(effort="standard"), device=CPU)
        for name in calls:
            calls[name] = 0
        res = t.solve(vs)
        assert res.migrations == 0
        counts.append(dict(calls))
    assert counts[0] == counts[1]
    assert counts[0]["delta_sweep"] > 0 and counts[0]["_chain_step"] == 2000


# ---------------------------------------------------------------------------
# sessions: 1 region == flat, conservation, budgets, churn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_single_region_parity_exact(seed):
    """A federation of one region reproduces the flat ``CFNSession``'s
    placements and float64 power exactly, and the reference's."""
    jt, tt = jtopo.paper_topology(), ttopo.paper_topology()
    vs_t = tvsr.random_vsrs(5, rng=seed, source_nodes=[0])
    flat = TSession(tt, TSpec(effort="quick"), device=CPU)
    fed = TFed(tt, TSpec(effort="quick"), device=CPU)
    rf, rr = flat.solve(vs_t), fed.solve(vs_t)
    np.testing.assert_array_equal(rf.X, rr.X)
    jr = JFed(jt, JSpec(effort="quick")).solve(
        jvsr.random_vsrs(5, rng=seed, source_nodes=[0]))
    np.testing.assert_array_equal(rr.X, np.asarray(jr.X))
    _, oracle_f = _oracle_gap(tt, vs_t, rf.X, 0.0)
    _, oracle_r = _oracle_gap(tt, vs_t, rr.X, 0.0)
    assert oracle_f == oracle_r
    bd = fed.breakdown()
    assert bd.objective == pytest.approx(oracle_r, rel=1e-12)
    assert bd.regional_w.shape == (1,) and bd.inter_region_w == 0.0
    assert fed.G == 1 and fed.assignment(0) == 0
    assert fed.sids == flat.sids and fed.n_live == 5
    # churn delegates too
    s = tvsr.random_vsrs(1, rng=40 + seed, source_nodes=[0])
    np.testing.assert_array_equal(fed.add(s, sid=9).X, flat.add(s, sid=9).X)
    with pytest.raises(ValueError, match="multi-region"):
        fed.fail_region(0)


def test_multi_region_conservation(fed):
    """Regional + inter-region watts == the float64 oracle of the
    equivalent flat placement with cross-region services in play, and the
    placements are the reference's."""
    jt, tt, _, tpart = fed
    srcs = _srcs(tpart)
    tvs = tvsr.random_vsrs(6, rng=1, source_nodes=srcs)
    homes = [tpart.home_region(int(s)) for s in tvs.src]
    aff = np.full(6, -1)
    aff[0] = (homes[0] + 1) % 3
    aff[1] = (homes[1] + 2) % 3
    sess = TFed(tt, TSpec(effort="quick", region_affinity=aff), device=CPU)
    res = sess.solve(tvs)
    bd = res.breakdown
    _conserved(bd)
    gap, oracle = _oracle_gap(tt, tvs, res.X, bd.objective)
    assert gap <= 1e-7 * max(1.0, abs(oracle))
    assert res.assignments[0] == aff[0] and res.assignments[1] == aff[1]
    assert bd.inter_region_w > 0.0
    assert abs(sess.breakdown().objective - oracle) \
        <= 1e-7 * max(1.0, abs(oracle))
    jres = JFed(jt, JSpec(effort="quick", region_affinity=aff)).solve(
        jvsr.random_vsrs(6, rng=1, source_nodes=srcs))
    np.testing.assert_array_equal(res.X, np.asarray(jres.X))
    np.testing.assert_array_equal(res.assignments, jres.assignments)
    np.testing.assert_allclose(res.region_obj, np.asarray(jres.region_obj),
                               rtol=1e-5)
    assert res.breakdown.total_w == pytest.approx(jres.breakdown.total_w,
                                                  rel=1e-12)


def test_four_region_batch_on_real_nodes():
    """A 4-region batch solve pads every region onto one (P, N, K) bucket
    and places every free VM on a real node of its assigned region."""
    _, tt, _, tpart = _fed(n_regions=4, n_olt=1, onus_per_olt=2,
                           iot_per_onu=2, n_core=4)
    subs, _, (P_pad, N_pad, K_pad) = tpart.padded_substrates(CPU)
    for d in subs:
        assert tuple(d["route_idx"].shape) == (P_pad, P_pad, K_pad)
        assert tuple(d["E"].shape) == (P_pad,)
    vs = tvsr.random_vsrs(8, rng=0, source_nodes=_srcs(tpart))
    res = TFed(tt, TSpec(effort="quick"), device=CPU).solve(vs)
    for i, g in enumerate(res.assignments):
        free = np.arange(vs.V) != int(vs.input_vm[i])
        assert np.isin(res.X[i][free], tpart.regions[g].proc_ids).all()


def test_batch_coordinator_migrates_on_budget():
    """The batch coordinator migrates services off an over-budget region,
    re-solving after every move: the reference's migrations, placements
    and monitor counts, exactly conserved, cut links priced."""
    jt, tt, _, tpart = _fed(n_regions=2, n_olt=1, onus_per_olt=2,
                            iot_per_onu=2, n_core=4)
    src0 = _srcs(tpart)[0]
    kw = dict(effort="quick", region_power_budget_w=[150.0, 1e9])
    tm, jm = TMonitor(), JMonitor()
    tvs = tvsr.random_vsrs(5, rng=0, source_nodes=[src0])
    res = TFed(tt, TSpec(**kw), device=CPU, monitor=tm).solve(tvs)
    assert res.migrations >= 1
    assert (res.assignments == 1).sum() == res.migrations
    assert tm.get("cross_region_migration") == res.migrations
    assert res.breakdown.inter_region_w > 0.0
    gap, oracle = _oracle_gap(tt, tvs, res.X, res.breakdown.objective)
    assert gap <= 1e-7 * max(1.0, abs(oracle))
    jres = JFed(jt, JSpec(**kw), monitor=jm).solve(
        jvsr.random_vsrs(5, rng=0, source_nodes=[src0]))
    assert res.migrations == jres.migrations
    np.testing.assert_array_equal(res.X, np.asarray(jres.X))
    assert tm.counters == jm.counters and tm.events == jm.events


def test_single_vm_services_solve(fed):
    """All-pinned workloads (V=1 services) solve on the batched path."""
    _, tt, _, tpart = fed
    srcs = _srcs(tpart)
    vs = tvsr.VSRBatch(F=np.full((3, 1), 0.4, np.float32),
                       H=np.zeros((3, 1, 1), np.float32),
                       src=np.asarray(srcs, np.int32),
                       input_vm=np.zeros(3, np.int32))
    res = TFed(tt, TSpec(effort="quick"), device=CPU).solve(vs)
    np.testing.assert_array_equal(res.X[:, 0], np.asarray(srcs))
    gap, oracle = _oracle_gap(tt, vs, res.X, res.breakdown.objective)
    assert gap <= 1e-7 * max(1.0, abs(oracle))


def test_solve_twice_refused_and_repack(fed):
    """A second batch on a live session raises; ``solve()`` with no batch
    re-packs every region (a per-region defrag, never worse)."""
    jt, tt, _, tpart = fed
    tw = FedTwin((jt, tt), QUICK)
    srcs = _srcs(tpart)
    jvs = jvsr.random_vsrs(6, rng=2, source_nodes=srcs)
    tvs = tvsr.random_vsrs(6, rng=2, source_nodes=srcs)
    jr, tr = tw.j.solve(jvs), tw.t.solve(tvs)
    np.testing.assert_array_equal(tr.X, np.asarray(jr.X))
    tw.check()
    with pytest.raises(ValueError, match="live services"):
        tw.t.solve(tvs)
    before = tw.t.power_w()
    jd, td = tw.j.solve(), tw.t.solve()
    assert sorted(td) == sorted(jd)
    tw.check()
    assert tw.t.power_w() <= before + 1e-6
    assert tw.t.result is tr


def test_region_affinity_never_violated_under_churn(fed):
    """Scalar region_affinity pins every service's free VMs to the target
    region through a whole churn replay (the reference test's spec, its
    100-step engine anneal on the port's own stream)."""
    _, tt, _, tpart = fed
    target = 1
    spec = TSpec(effort="quick", region_affinity=target, defrag_every=0,
                 anneal_steps=100)
    sess = TFed(tt, spec, device=CPU)
    srcs = _srcs(tpart)
    make = lambda sid: tvsr.random_vsrs(1, rng=100 + sid,
                                        source_nodes=[srcs[sid % 3]])
    events = [tdyn.ServiceEvent(float(t), "arrive", t) for t in range(4)]
    events += [tdyn.ServiceEvent(5.0, "depart", 1),
               tdyn.ServiceEvent(6.0, "arrive", 9),
               tdyn.ServiceEvent(7.0, "depart", 0)]
    reg = tpart.regions[target]

    def check(ev, res):
        X = sess.X
        for row, sid in enumerate(sess.sids):
            assert sess.assignment(sid) == target
            plan = sess._plans[sid]
            iv = int(plan.vsr.input_vm[0])
            for v in range(plan.vsr.V):
                if v != iv:
                    assert X[row, v] in reg.proc_ids, (sid, v, X[row, v])
        _conserved(sess.breakdown())

    stats = sess.replay(events, make, on_event=check)
    assert sess.n_live == 3 and len(stats) == len(events)


def test_churn_twin_matches_jax_call_for_call(fed):
    """Deterministic spec: adds (home, region=, affinity-free), removes
    of a migrated and a local service, the per-region defrag and defrag
    tick -- placements, assignments, sids, objectives and fleet watts equal
    to the reference's after every call, and the float64 oracle holds."""
    jt, tt, _, tpart = fed
    srcs = _srcs(tpart)
    tw = FedTwin((jt, tt), QUICK, monitors=True)
    tw.add(20, srcs[0], sid=0)
    tw.add(21, srcs[1], sid=1)
    tw.add(22, srcs[0], sid=2, region=2)     # cross-region
    tw.add(23, srcs[2], sid=3, priority=0)
    assert tw.t._plans[2].migrated and tw.t.assignment(2) == 2
    tw.do("remove", 2)
    tw.do("remove", 0)
    tw.add(24, srcs[1])                      # auto sid 4
    assert tw.t.sids[-1] == 4
    tw.do("defrag_tick", 1)
    tw.do("defrag")
    batch = _chain([tw.t._plans[s].vsr for s in tw.t.sids])
    gap, oracle = _oracle_gap(tt, batch, tw.t.X, tw.t.breakdown().objective)
    assert gap <= 1e-7 * max(1.0, abs(oracle))
    with pytest.raises(KeyError):
        tw.t.remove(77)
    with pytest.raises(ValueError, match="already live"):
        tw.t.add(_svc(tvsr, 1, srcs[0]), sid=1)
    per = tw.t.attribute()
    assert set(per) == set(tw.t.sids)
    assert abs(sum(per.values()) - tw.t.power_w()) \
        <= 1e-6 * tw.t.power_w()
    assert tw.t.service_vms(0) == 3


def test_online_churn_conservation(fed):
    """After every add / remove the exact federated accounting equals the
    float64 oracle of the merged live placement (the reference test's
    spec, its 100-step engine anneal on the port's own stream)."""
    _, tt, _, tpart = fed
    srcs = _srcs(tpart)
    sess = TFed(tt, TSpec(effort="quick", defrag_every=0, anneal_steps=100),
                device=CPU)
    live = {}

    def held():
        batch = _chain([live[s] for s in sess.sids])
        bd = sess.breakdown()
        gap, oracle = _oracle_gap(tt, batch, sess.X, bd.objective)
        assert gap <= 1e-7 * max(1.0, abs(oracle))
        _conserved(bd)

    for i in range(3):
        s = tvsr.random_vsrs(1, rng=20 + i, source_nodes=[srcs[i % 3]])
        assert sess.add(s, sid=i) is not None
        live[i] = s
        held()
    sess.remove(1)
    del live[1]
    held()
    s = tvsr.random_vsrs(1, rng=40, source_nodes=[srcs[1]])
    sess.add(s, sid=7)
    live[7] = s
    held()


def test_budget_breach_migrates_and_counts():
    """An arrival pushing its region past region_power_budget_w moves to
    the coolest admissible region; breach + migration hit the monitor --
    the reference's assignments, placements and counts (deterministic
    spec), and the reference test's checks under its own spec."""
    jt, tt, _, tpart = _fed(n_regions=2, n_olt=1, onus_per_olt=2,
                            iot_per_onu=2, n_core=4)
    src0 = _srcs(tpart)[0]
    budget = dict(region_power_budget_w=[180.0, 1e9])
    tw = FedTwin((jt, tt), dict(QUICK, **budget), monitors=True)
    for i in range(4):
        assert tw.add(i, src0) is not None
    assigned = [tw.t.assignment(i) for i in range(4)]
    assert assigned[-1] == 1, assigned
    assert tw.tm.get("region_budget_breach") >= 1
    assert tw.tm.get("cross_region_migration") >= 1
    assert tw.t.breakdown().inter_region_w > 0.0
    plan = tw.t._plans[3]
    assert plan.migrated and plan.home == 0 and plan.assigned == 1
    assert tw.t.X[3, int(plan.vsr.input_vm[0])] == src0
    # the reference test's spec (100-step engine anneal, port stream)
    mon = TMonitor()
    sess = TFed(tt, TSpec(effort="quick", defrag_every=0, anneal_steps=100,
                          **budget), device=CPU, monitor=mon)
    for i in range(4):
        assert sess.add(tvsr.random_vsrs(1, rng=i,
                                         source_nodes=[src0])) is not None
    assert sess.assignment(3) == 1
    assert mon.get("region_budget_breach") >= 1
    assert mon.get("cross_region_migration") >= 1


def test_attribute_sums_to_total_with_migrations(fed):
    _, tt, _, tpart = fed
    srcs = _srcs(tpart)
    sess = TFed(tt, TSpec(effort="quick", anneal_steps=100, defrag_every=0),
                device=CPU)
    for i in range(3):
        sess.add(tvsr.random_vsrs(1, rng=30 + i, source_nodes=[srcs[0]]),
                 sid=i, region=i)
    per = sess.attribute()
    bd = sess.breakdown()
    assert bd.inter_region_w > 0.0
    assert abs(sum(per.values()) - bd.total_w) <= 1e-6 * bd.total_w
    assert sess.region_watts() == pytest.approx(bd.regional_w)


def test_churn_respects_inter_region_hop_cap(fed):
    _, tt, _, tpart = fed
    srcs = _srcs(tpart)
    far = int(tpart.core_hops[0].max())
    sess = TFed(tt, TSpec(effort="quick", inter_region_hops=far - 1,
                          anneal_steps=100), device=CPU)
    over = int(np.argmax(tpart.core_hops[0]))
    with pytest.raises(ValueError, match="inter_region_hops"):
        sess.add(tvsr.random_vsrs(1, rng=0, source_nodes=[srcs[0]]),
                 region=over)
    # the batch path's affinity check
    vs = tvsr.random_vsrs(1, rng=0, source_nodes=[srcs[0]])
    sess2 = TFed(tt, TSpec(effort="quick", inter_region_hops=far - 1,
                           region_affinity=over), device=CPU)
    with pytest.raises(ValueError, match="inter_region_hops"):
        sess2.solve(vs)


def test_monitor_counts_admission_rejections():
    """The flat engine reports admission rejections on the monitor (the
    reference test, on the port's ``CFNSession``)."""
    topo = ttopo.paper_topology()
    mon = TMonitor()
    sess = TSession(topo, TSpec(power_budget_w=1e-6, effort="quick",
                                anneal_steps=50), device=CPU, monitor=mon)
    assert sess.add(tvsr.random_vsrs(1, rng=0, source_nodes=[0])) is None
    assert sess.add(tvsr.random_vsrs(1, rng=1, source_nodes=[0])) is None
    assert mon.get("admission_rejected") == 2
    assert mon.get("power_budget_exceeded") == 2
    assert sess.admission["rejected"] == 2


@pytest.mark.parametrize("kw", [dict(max_hops=[1, 2, 3]),
                                dict(eligible=np.ones((2, 21), bool)),
                                dict(preempt=True)],
                         ids=["seq_max_hops", "eligible", "preempt"])
def test_spec_rejects_unsupported_for_federation(fed, kw):
    _, tt, _, _ = fed
    with pytest.raises(ValueError):
        TFed(tt, TSpec(**kw), device=CPU)


def test_add_explicit_region_and_sequence_guard(fed):
    _, tt, _, tpart = fed
    srcs = _srcs(tpart)
    sess = TFed(tt, TSpec(effort="quick", anneal_steps=100, defrag_every=0),
                device=CPU)
    svc = tvsr.random_vsrs(1, rng=0, source_nodes=[srcs[0]])
    assert sess.add(svc, sid=0, region=2) is not None
    assert sess.assignment(0) == 2 and sess._plans[0].migrated
    sess2 = TFed(tt, TSpec(effort="quick", region_affinity=[1, 2]),
                 device=CPU)
    with pytest.raises(ValueError, match="sequence region_affinity"):
        sess2.add(tvsr.random_vsrs(1, rng=1, source_nodes=[srcs[0]]))
    with pytest.raises(ValueError, match="sequence region_affinity"):
        sess2.apply_wave([tvsr.random_vsrs(1, rng=1,
                                           source_nodes=[srcs[0]])])
    with pytest.raises(ValueError, match="one service"):
        sess.add(tvsr.random_vsrs(2, rng=1, source_nodes=[srcs[0]]))


def test_wave_twin_matches_jax(fed):
    """``apply_wave``: local arrivals batch per region, an affinity /
    budget-free cross-region departure retires per event -- the wave
    result's lists, placements and watts equal to the reference's."""
    jt, tt, _, tpart = fed
    srcs = _srcs(tpart)
    tw = FedTwin((jt, tt), QUICK, monitors=True)
    for i, g in enumerate([0, 1, 2, 0]):
        tw.add(50 + i, srcs[g], sid=i)
    tw.add(54, srcs[1], sid=4, region=0)     # migrated body in region 0
    jarr, tarr = [], []
    for k, (seed, g) in enumerate([(60, 0), (61, 1), (62, 2), (63, 1)]):
        jsv, tsv = tw.svc(seed, srcs[g])
        jarr.append((jsv, 10 + k))
        tarr.append((tsv, 10 + k, 0))
    jw = tw.j.apply_wave(jarr, [1, 4])
    twr = tw.t.apply_wave(tarr, [1, 4])
    tw.check()
    for name in ("sids", "admitted", "rejected", "queued", "departed",
                 "n_preempted"):
        assert getattr(twr, name) == getattr(jw, name), name
    assert twr.result is None
    assert tw.t.apply_wave().sids == []
    with pytest.raises(ValueError, match="duplicate"):
        tw.t.apply_wave(departures=[0, 0])
    with pytest.raises(KeyError):
        tw.t.apply_wave(departures=[99])


def test_scheduler_drives_federated_session(fed):
    """``EnergyAwareScheduler(session=FederatedSession(...))``: services
    stay in their home regions, per-tenant watts report, and the
    placements are the reference scheduler's under the deterministic
    spec."""
    from repro.configs.h2o_danube_3_4b import CONFIG as JARCH
    from repro.serve.scheduler import (EnergyAwareScheduler as JSched,
                                       Service as JService)
    from repro_torch.configs.h2o_danube_3_4b import CONFIG as TARCH
    from repro_torch.serve.scheduler import (EnergyAwareScheduler as TSched,
                                             Service as TService)
    jt, tt, _, tpart = fed
    srcs = _srcs(tpart)
    for kw in (dict(effort="quick", anneal_steps=100, defrag_every=0),
               QUICK):
        sess = TFed(tt, TSpec(**kw), device=CPU)
        sched = TSched(tt, session=sess)
        sched.add_service(TService("svc-a", TARCH, tokens_per_s=5.0,
                                   n_stages=2, source_node=srcs[0]))
        pls = sched.add_service(TService("svc-b", TARCH, tokens_per_s=5.0,
                                         n_stages=2, source_node=srcs[1]))
        assert [p.service for p in pls] == ["svc-a", "svc-b"]
        for p, g in zip(pls, (0, 1)):
            names = set(tpart.regions[g].topo.proc_names)
            assert all(n in names for n in p.stage_nodes)
        assert sched.total_power_w() > 0
        assert sum(p.power_w for p in pls) == pytest.approx(
            sched.total_power_w(), rel=1e-6)
    jsched = JSched(jt, session=JFed(jt, JSpec(**QUICK)))
    for name, src in (("svc-a", srcs[0]), ("svc-b", srcs[1])):
        jpls = jsched.add_service(JService(name, JARCH, tokens_per_s=5.0,
                                           n_stages=2, source_node=src))
    assert [p.stage_nodes for p in pls] == [p.stage_nodes for p in jpls]
    np.testing.assert_allclose([p.power_w for p in pls],
                               [p.power_w for p in jpls], rtol=1e-5)
    sched.remove_service("svc-a")
    assert [p.service for p in sched.placements()] == ["svc-b"]


def test_federated_scale_smoke():
    """The default federated_scale (4 regions, P=64) batch solve + churn:
    feasible, conserved, the float64 oracle (the reference's slow smoke,
    eager here and quick)."""
    _, tt, _, tpart = _fed()
    assert tt.P == 64 and tpart.G == 4
    srcs = _srcs(tpart)
    vs = tvsr.random_vsrs(12, rng=0, source_nodes=srcs)
    sess = TFed(tt, TSpec(effort="quick", anneal_steps=150), device=CPU)
    res = sess.solve(vs)
    assert res.breakdown.violation <= 1e-6
    gap, oracle = _oracle_gap(tt, vs, res.X, res.breakdown.objective)
    assert gap <= 1e-7 * max(1.0, abs(oracle))
    assert sess.add(tvsr.random_vsrs(1, rng=77,
                                     source_nodes=[srcs[2]])) is not None
    sess.remove(3)
    assert sess.n_live == 12
    _conserved(sess.breakdown())


def test_replay_waves_with_defrag_tick(fed):
    """``replay(waves=True)``: same-tick events in one ``apply_wave``, a
    defrag tick after each wave -- the reference's placements after the
    whole flash crowd (deterministic spec)."""
    jt, tt, _, tpart = fed
    srcs = _srcs(tpart)
    tw = FedTwin((jt, tt), dict(QUICK, defrag_rows_per_tick=2),
                 monitors=True)
    ev = lambda pkg: pkg.flash_crowd_trace(6, 2, 4, rng=0)
    make = lambda pkg: (lambda sid: _svc(pkg, 300 + sid, srcs[sid % 3]))
    js_ = tw.j.replay(ev(jdyn), make(jvsr), waves=True)
    ts_ = tw.t.replay(ev(tdyn), make(tvsr), waves=True)
    assert len(ts_) == len(js_)
    tw.check()
    assert tw.t.n_live == 6


def test_import_purity_of_federation():
    """The port's federation loads neither jax nor the JAX package."""
    code = ("import sys, repro_torch.core.federation\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(REPO / "src"),
                                       "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
