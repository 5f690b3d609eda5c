"""The energy-aware serving scheduler of the PyTorch port against the JAX
package's, on the CPU and ``datacenter_topology()`` (the template is
``tests/test_system.py``'s scheduler cases, with its services: qwen3-4b
and olmoe-1b-7b at 500 tokens/s, hymba-1.5b at 250 in 3 stages).

Both schedulers run the same calls under the deterministic spec (cfn-milp
"quick", no anneal, no periodic defrag): placements (stage nodes, layers)
equal, per-service and fleet watts rtol 1e-5, the rejected / queued names,
live sids and the monitors' counters equal.  The default spec (the
4000-step anneal, on the port's own random stream) is held to the
reference test's own checks.  The cost bridge ``from_architecture`` gives
the reference's VSRs for the MoE and hybrid configurations too."""
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.api import PlacementSpec as JSpec
from repro.core import topology as jtopo, vsr as jvsr
from repro.fault.monitor import PlacementMonitor as JMonitor
from repro.serve.scheduler import (EnergyAwareScheduler as JSched,
                                   Service as JService)
from repro_torch import configs as tconfigs
from repro_torch.api import CFNSession, PlacementSpec as TSpec
from repro_torch.core import topology as ttopo, vsr as tvsr
from repro_torch.fault import PlacementMonitor as TMonitor
from repro_torch.serve.scheduler import (EnergyAwareScheduler as TSched,
                                         Service as TService)

CPU = "cpu"
QUICK = dict(effort="quick", anneal_steps=0, defrag_every=0)
W_TOL = dict(rtol=1e-5, atol=1e-3)
# tests/test_system.py's services: (name, arch, tokens/s, n_stages)
SERVICES = {"qwen": ("qwen3-4b", 500.0, 4), "olmoe": ("olmoe-1b-7b", 500.0, 4),
            "hymba": ("hymba-1.5b", 250.0, 3)}


@pytest.fixture(scope="module")
def dc():
    return jtopo.datacenter_topology(), ttopo.datacenter_topology()


class SchedTwin:
    """A JAX and a port scheduler, each with its own monitor, fed the same
    calls; ``svc(name, **kw)`` builds a service of ``SERVICES`` in both."""

    def __init__(self, topos, **spec_kw):
        jt, tt = topos
        self.jm, self.tm = JMonitor(), TMonitor()
        self.j = JSched(jt, spec=JSpec(**QUICK, **spec_kw), monitor=self.jm)
        self.t = TSched(tt, spec=TSpec(**QUICK, **spec_kw), monitor=self.tm,
                        device=CPU)

    @staticmethod
    def svc(name, tokens_per_s=None, **kw):
        arch, tok, stages = SERVICES[name.split("#")[0]]
        tok = tok if tokens_per_s is None else tokens_per_s
        return (JService(name, jconfigs.get(arch), tok, n_stages=stages,
                         **kw),
                TService(name, tconfigs.get(arch), tok, n_stages=stages,
                         **kw))

    def call(self, name, *args):
        """Run ``name`` on both schedulers (arguments given as (jax, port)
        pairs, lists of them, or plain values) and hold them equal."""
        one = lambda a, k: a[k] if isinstance(a, tuple) else a
        pick = lambda k: [[one(x, k) for x in a] if isinstance(a, list)
                          else one(a, k) for a in args]
        jr = getattr(self.j, name)(*pick(0))
        tr = getattr(self.t, name)(*pick(1))
        if isinstance(jr, list):
            same_placements(tr, jr)
        self.check()
        return tr

    def session(self, name, *args):
        """Run a session method (a brownout) on both schedulers' sessions."""
        getattr(self.j.session, name)(*args)
        getattr(self.t.session, name)(*args)

    def check(self):
        same_placements(self.t.placements(), self.j.placements())
        np.testing.assert_allclose(self.t.total_power_w(),
                                   self.j.total_power_w(), **W_TOL)
        assert [s.name for s in self.t.services] == \
            [s.name for s in self.j.services]
        assert self.t.rejected == self.j.rejected
        assert self.t.queued == self.j.queued
        assert self.t.session.sids == self.j.session.sids
        assert self.t.session.engine.queued_sids == \
            self.j.session.engine.queued_sids
        assert self.tm.counters == self.jm.counters


def same_placements(got, want):
    assert [p.service for p in got] == [p.service for p in want]
    for g, w in zip(got, want):
        assert g.stage_nodes == w.stage_nodes
        assert g.layers == w.layers
        np.testing.assert_allclose(g.power_w, w.power_w, **W_TOL)


def _attribution_sums(sched):
    total = sched.total_power_w()
    got = sum(p.power_w for p in sched.placements())
    assert abs(got - total) <= 1e-5 * max(total, 1.0) + 1e-3


def test_scheduler_places_and_saves_energy(dc):
    """qwen and olmoe placed as the reference places them: input VM + 4
    stages each, per-service watts summing to the fleet's, and the
    reference's saving vs the cloud."""
    tw = SchedTwin(dc)
    tw.call("add_service", tw.svc("qwen"))
    placements = tw.call("add_service", tw.svc("olmoe"))
    assert len(placements) == 2
    assert all(len(p.stage_nodes) == 5 for p in placements)
    _attribution_sums(tw.t)
    got, want = tw.t.savings_vs_cloud(), tw.j.savings_vs_cloud()
    assert sorted(got) == sorted(want) == ["baseline_w", "optimized_w",
                                           "saving_frac"]
    np.testing.assert_allclose(got["baseline_w"], want["baseline_w"],
                               rtol=1e-5)
    assert got["saving_frac"] > 0.0
    assert got["saving_frac"] >= want["saving_frac"] - 1e-3
    assert tw.t.solve() == tw.t.placements()


def test_scheduler_default_spec(dc):
    """The default spec (cfn-milp, standard effort: the anneal on the
    port's own stream) passes the reference test's checks."""
    _, tt = dc
    sched = TSched(tt, device=CPU)
    assert sched.method == "cfn-milp" and sched.spec.defrag_every == 16
    for name in ("qwen", "olmoe"):
        sched.add_service(SchedTwin.svc(name)[1])
    placements = sched.solve()
    assert len(placements) == 2
    assert all(len(p.stage_nodes) == 5 for p in placements)
    _attribution_sums(sched)
    assert sched.savings_vs_cloud()["saving_frac"] > 0.0


def test_scheduler_online_churn(dc):
    """remove_service is a churn event: placements shrink, attribution
    re-sums, names key the removal API, re-adding stays consistent."""
    tw = SchedTwin(dc)
    tw.call("add_service", tw.svc("qwen"))
    tw.call("add_service", tw.svc("olmoe"))
    p_two = tw.t.total_power_w()
    placements = tw.call("remove_service", "qwen")
    assert [p.service for p in placements] == ["olmoe"]
    assert tw.t.total_power_w() < p_two
    with pytest.raises(ValueError, match="already live"):
        tw.t.add_service(tw.svc("olmoe", tokens_per_s=1.0)[1])
    with pytest.raises(KeyError):
        tw.t.remove_service("nonexistent")
    placements = tw.call("add_service", tw.svc("hymba"))
    assert {p.service for p in placements} == {"olmoe", "hymba"}
    by_name = {p.service: p for p in placements}
    assert len(by_name["hymba"].stage_nodes) == 4
    _attribution_sums(tw.t)
    tw.call("defrag")


def test_scheduler_batches_are_waves(dc):
    """add_services is one wave, remove_services one departure wave: the
    reference's placements and sids; a duplicate name in a batch or a
    live name raises."""
    tw = SchedTwin(dc)
    tw.call("add_services", [tw.svc(n) for n in ("qwen", "olmoe")])
    tw.call("add_services", [tw.svc("hymba"), tw.svc("qwen#2",
                                                     tokens_per_s=80.0)])
    assert tw.t.session.stats[-1].event == "wave"
    with pytest.raises(ValueError, match="duplicate"):
        tw.t.add_services([tw.svc("olmoe#2")[1], tw.svc("olmoe#2")[1]])
    with pytest.raises(ValueError, match="already live"):
        tw.t.add_services([tw.svc("hymba")[1]])
    tw.call("remove_services", ["qwen", "hymba"])
    assert [s.name for s in tw.t.services] == ["olmoe", "qwen#2"]
    with pytest.raises(KeyError):
        tw.t.remove_services(["qwen"])
    _attribution_sums(tw.t)


def test_scheduler_admission_queue_and_monitor(dc):
    """Under a brownout a refused service is parked (queue_rejected),
    counted by the monitor, and re-enters the fleet by name once the
    brownout ends and the scheduler next reconciles -- as the reference.
    (A first service pays the substrate's idle watts, ~826 W here; each
    later one 10-50 W.)"""
    tw = SchedTwin(dc, queue_rejected=True)
    tw.call("add_service", tw.svc("olmoe"))
    tw.session("brownout", 20.0)
    tw.call("add_service", tw.svc("qwen", tokens_per_s=5000.0))
    assert tw.t.queued == ["qwen"] and tw.tm["admission_rejected"] == 1
    assert tw.tm["power_budget_exceeded"] == 1 and tw.tm["brownout"] == 1
    tw.session("brownout_end")
    tw.call("add_service", tw.svc("hymba", tokens_per_s=10.0))
    assert tw.t.queued == [] and "qwen" in [s.name for s in tw.t.services]
    tw.call("remove_service", "olmoe")


def test_scheduler_rejects_without_queue(dc):
    tw = SchedTwin(dc)
    tw.call("add_service", tw.svc("olmoe"))
    tw.session("brownout", 20.0)
    tw.call("add_service", tw.svc("qwen", tokens_per_s=5000.0))
    assert tw.t.rejected == ["qwen"] and tw.t.queued == []
    assert [p.service for p in tw.t.placements()] == ["olmoe"]


def test_scheduler_preemption_moves_live_to_queued(dc):
    """A class-0 arrival refused under a brownout preempts the class-1
    service: the victim moves live -> queued in the scheduler's books, and
    both come back after the brownout -- as in the reference's."""
    tw = SchedTwin(dc, queue_rejected=True, priority_classes=2, preempt=True)
    tw.call("add_service", tw.svc("olmoe", priority=1))
    tw.session("brownout", 20.0)
    tw.call("add_service", tw.svc("qwen", tokens_per_s=5000.0, priority=0))
    assert tw.tm["preempted"] == 1 and tw.t.services == []
    assert tw.t.queued == ["qwen", "olmoe"]
    tw.session("brownout_end")
    tw.call("add_service", tw.svc("hymba", tokens_per_s=10.0))
    assert sorted(s.name for s in tw.t.services) == ["hymba", "olmoe", "qwen"]


def test_scheduler_session_argument_and_telemetry(dc):
    """A pre-built session is used as given (a monitor and a telemetry
    attach to it, the monitor mirrored there); a scheduler built with
    ``telemetry=`` hands it to its own session, which records the
    service's commit."""
    from repro_torch.telemetry import Telemetry
    _, tt = dc
    ses = CFNSession(tt, TSpec(**QUICK), device=CPU)
    mon, tel = TMonitor(), Telemetry()
    sched = TSched(tt, session=ses, monitor=mon, telemetry=tel)
    assert sched.session is ses and ses.engine.monitor is mon
    assert ses.telemetry is tel and mon.telemetry is tel
    sched.add_service(SchedTwin.svc("hymba")[1])
    assert ses.sids == [0] and len(sched.placements()) == 1
    own = Telemetry()
    sched2 = TSched(tt, spec=TSpec(**QUICK), telemetry=own, device=CPU)
    assert sched2.session.telemetry is own
    sched2.add_service(SchedTwin.svc("hymba")[1])
    for t in (tel, own):
        assert [e["event"] for e in t.events if e["type"] == "solve"] == \
            ["add"]
        assert len(t.ledger.samples) == 1


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "hymba-1.5b",
                                  "internvl2-2b", "xlstm-1.3b",
                                  "whisper-base"])
def test_from_architecture_moe_and_hybrid_match_reference(arch):
    """The cost bridge counts the MoE (active experts top_k / n_experts),
    hybrid and xLSTM blocks (no attention term) and whisper's decoder
    blocks (cross-attention projections; the encoder not a VM) from their
    shapes: the reference's VSR."""
    kw = dict(tokens_per_s=1234.5, n_stages=4, context=1536, source_node=3)
    want = jvsr.from_architecture(jconfigs.get(arch), **kw)
    got = tvsr.from_architecture(tconfigs.get(arch), **kw)
    for f in ("F", "H", "src", "input_vm"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6)
