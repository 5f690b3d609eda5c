"""Region faults of the port's ``FederatedSession`` against the JAX
package's, on the CPU (the template is the federated cases of
``tests/test_faults.py``).

A JAX and a port session, each with its own ``PlacementMonitor``, take
the same calls on the reference's fixture ``federated_scale(3, n_olt=1,
onus_per_olt=2, iot_per_onu=2, n_core=6)`` under the reference test's
deterministic spec (cfn-milp "quick", no engine anneal, no periodic
defrag): after every call they agree on placements, assignments, sids,
the fault queue, the down regions, the exact fleet watts (rtol 1e-12),
the monitors' counters, events, open strand windows and stranded
service time.  On top: the reference test's own checks (evacuation,
stranding, recovery, the float64 oracle, the monitor roll-up), a
brownout that sheds load across regions, ``apply_fault`` dispatch and
refusals, fault events in both replay modes, and ``cancel_queued``."""
import numpy as np
import pytest

from repro.core import dynamic as jdyn, vsr as jvsr
from repro_torch.core import dynamic as tdyn, vsr as tvsr
from repro_torch.fault import PlacementMonitor as TMonitor
from repro_torch.kernels import ref as tref
from test_torch_federation import (CPU, FED, QUICK, FedTwin, TFed, TSpec,
                                   _conserved, _fed, _srcs)


@pytest.fixture(scope="module")
def fed():
    return _fed(**FED)


def _twin(fed, homes, **spec_kw):
    """A monitored twin with one service a home in ``homes`` (sids 0..),
    each from numpy seed sid at its home region's first node."""
    jt, tt, _, tpart = fed
    tw = FedTwin((jt, tt), dict(QUICK, **spec_kw), monitors=True)
    srcs = _srcs(tpart)
    for i, g in enumerate(homes):
        assert tw.add(i, srcs[g], sid=i) is not None
    return tw, srcs


def _merged_oracle(sess):
    vs = tvsr.concat_all([sess._plans[s].vsr for s in sess._order])
    from repro_torch.core import power as tp
    prob = tp.build_problem(sess.topo, vs, device=CPU)
    X = np.asarray(sess.X)[:vs.R, :vs.V]
    return tref.placement_objective_f64(prob, X)


def test_federated_evacuation_and_conservation(fed):
    tw, srcs = _twin(fed, [0, 0, 2])
    # a cross-hosted body: homed in region 0, placed in region 1
    assert tw.add(3, srcs[0], sid=3, region=1) is not None
    assert tw.t.assignment(3) == 1
    tw.do("tick", 1.0)
    n_evac = tw.do("fail_region", 1)
    assert n_evac == 1 and tw.tm["evacuation"] == 1
    assert tw.t.assignment(3) != 1
    assert tw.t.down_regions == [1]
    assert set(tw.t.sids) == {0, 1, 2, 3}
    bd = tw.t.breakdown()
    oracle = _merged_oracle(tw.t)
    assert abs(oracle - bd.objective) <= 1e-7 * max(1.0, abs(oracle))
    tw.do("recover_region", 1)
    assert tw.t.down_regions == []
    assert tw.do("fail_region", 1) == 0 and tw.do("fail_region", 1) == 0
    assert tw.do("recover_region", 1) == 0


def test_federated_region_failure_strands_homed_services(fed):
    tw, srcs = _twin(fed, [0, 1, 1, 2])
    tw.do("tick", 2.0)
    tw.do("fail_region", 1)
    assert set(tw.t.sids) == {0, 3}
    assert tw.tm["service_stranded"] == 2
    assert tw.add(9, srcs[1], sid=9) is None    # parks, never drops
    assert tw.tm["service_stranded"] == 3
    assert 9 in tw.t.queued_sids
    tw.do("tick", 6.0)
    assert tw.do("recover_region", 1) == 3
    assert set(tw.t.sids) == {0, 1, 2, 3, 9}
    assert not tw.tm.stranded_since
    assert tw.tm.stranded_service_s >= 4.0 * 2 - 1e-9
    assert float(tw.t.breakdown().objective) > 0
    oracle = _merged_oracle(tw.t)
    assert abs(oracle - tw.t.breakdown().objective) \
        <= 1e-7 * max(1.0, abs(oracle))


def test_federated_monitor_rollup(fed):
    jt, tt, _, tpart = fed
    tw = FedTwin((jt, tt), QUICK, monitors=True)
    jreg, treg = tw.j.attach_region_monitors(), tw.t.attach_region_monitors()
    assert set(treg) == {0, 1, 2}
    srcs = _srcs(tpart)
    for i, g in enumerate([0, 1, 2]):
        assert tw.add(i, srcs[g], sid=i) is not None
    tw.do("tick", 1.0)
    tw.do("fail_region", 1)
    tw.do("recover_region", 1)
    fleet, jfleet = tw.t.fleet_monitor(), tw.j.fleet_monitor()
    assert fleet["region_failed"] == 1 and fleet["region_recovered"] == 1
    total = sum(m.get("service_stranded") for m in treg.values())
    total += tw.tm.get("service_stranded")
    assert fleet["service_stranded"] == total == 1
    assert fleet.counters == jfleet.counters
    for g in treg:
        assert treg[g].counters == jreg[g].counters
    # the roll-up is the sum of every monitor's counters
    for kind, n in fleet.counters.items():
        assert n == tw.tm.get(kind) + sum(m.get(kind)
                                          for m in treg.values())


def test_brownout_region_sheds_and_restores(fed):
    """A region brownout sheds its heaviest services through the budget
    migration path (breach + migration counted), the end restores the
    budget and drains the parked ones -- the reference's calls, counts and
    placements."""
    tw, srcs = _twin(fed, [0, 0, 0, 1])
    w0 = float(tw.t.region_watts()[0])
    moved = tw.do("brownout_region", 0, 0.5 * w0)
    assert moved >= 1 and tw.tm["brownout"] == 1
    assert tw.tm["cross_region_migration"] >= 1
    assert any(tw.t.assignment(s) != 0 for s in tw.t.sids
               if tw.t._plans[s].home == 0)
    _conserved(tw.t.breakdown())
    tw.do("brownout_end_region", 0)
    assert tw.tm["brownout_end"] == 1
    tw.do("brownout_end_region", 0)           # no override: a no-op
    assert tw.tm["brownout_end"] == 1


def test_apply_fault_dispatch_and_refusals(fed):
    tw, srcs = _twin(fed, [0, 1, 2])
    for kind, target, value in (("fail_region", 2, None),
                                ("recover_region", 2, None),
                                ("brownout", 1, 1e9),
                                ("brownout_end", 1, None)):
        jr = tw.j.apply_fault(jdyn.FaultEvent(1.0, kind, target, value))
        tr = tw.t.apply_fault(tdyn.FaultEvent(1.0, kind, target, value))
        assert tr == jr, kind
        tw.check()
    for kind in ("fail_node", "recover_link"):
        with pytest.raises(ValueError, match="region-granular"):
            tw.t.apply_fault(tdyn.FaultEvent(1.0, kind, 0))


def _fault_timeline(pkg, srcs):
    """Arrivals at t = 0..5 round-robin over the regions, region 1 failing
    at 2.5 (an arrival homed there parks) and recovering at 4.5, two
    departures -- one of a service parked at the time (cancelled)."""
    ev = [pkg.ServiceEvent(float(t), "arrive", t) for t in range(6)]
    ev += [pkg.ServiceEvent(4.2, "depart", 4),      # parked at 4.2
           pkg.ServiceEvent(5.5, "depart", 0)]
    faults = [pkg.FaultEvent(2.5, "fail_region", 1),
              pkg.FaultEvent(4.5, "recover_region", 1)]
    return pkg.merge_timelines(ev, faults)


@pytest.mark.parametrize("waves", [False, True], ids=["per_event", "waves"])
def test_replay_with_region_faults_matches_jax(fed, waves):
    jt, tt, _, tpart = fed
    srcs = _srcs(tpart)
    tw = FedTwin((jt, tt), QUICK, monitors=True)
    make = lambda pkg: (lambda sid: pkg.random_vsrs(
        1, rng=200 + sid, source_nodes=[srcs[sid % 3]]))
    seen = []

    def on_event(ev, res):
        seen.append(ev.kind)
        _conserved(tw.t.breakdown())

    js_ = tw.j.replay(_fault_timeline(jdyn, srcs), make(jvsr), waves=waves)
    ts_ = tw.t.replay(_fault_timeline(tdyn, srcs), make(tvsr),
                      on_event=on_event, waves=waves)
    assert [e.kind for e, _ in ts_] == [e.kind for e, _ in js_]
    assert "fail_region" in seen and "recover_region" in seen
    tw.check()
    assert tw.tm["region_failed"] == tw.tm["region_recovered"] == 1
    assert 4 not in tw.t.sids and 4 not in tw.t.queued_sids
    assert not tw.tm.stranded_since


def test_cancel_queued_closes_the_window(fed):
    tw, srcs = _twin(fed, [0, 1])
    tw.do("tick", 1.0)
    tw.do("fail_region", 1)
    assert 1 in tw.t.queued_sids
    tw.do("tick", 2.0)
    assert tw.do("cancel_queued", 1) is True
    assert tw.do("cancel_queued", 1) is False
    assert 1 not in tw.tm.stranded_since
    tw.do("recover_region", 1)
    assert tw.t.sids == [0]


def test_region_kinds_refused_by_a_flat_engine_and_one_region(fed):
    """The flat engine refuses region kinds, and a one-region federation
    (the flat session) refuses region faults, as the reference does."""
    from repro_torch.core import topology as ttopo
    flat = TFed(ttopo.paper_topology(), TSpec(**QUICK), device=CPU)
    for call in (lambda: flat.fail_region(0), lambda: flat.recover_region(0)):
        with pytest.raises(ValueError, match="multi-region"):
            call()
    flat.add(tvsr.random_vsrs(1, rng=0, source_nodes=[0]), sid=0)
    with pytest.raises(ValueError, match="region faults"):
        flat._flat.apply_fault(tdyn.FaultEvent(1.0, "fail_region", 0))
    mon = TMonitor()
    flat.attach_monitor(mon)
    flat.brownout_region(0, 1e-6)       # the flat session's brownout
    assert mon["brownout"] == 1
    flat.brownout_end_region(0)
    assert mon["brownout_end"] == 1
