"""The telemetry plane of the PyTorch port against the JAX package's, on the
CPU (the template is ``tests/test_telemetry.py``): the registry, the
energy ledger, the JSONL stream and its CLI, the monitor mirror, the
shape and launch attribution.

Both packages' registries take the same calls -- spans, counters, gauges,
histogram observations, ledger ticks, monitor counts -- and must come out
the same: counters, gauges and histogram buckets equal, Prometheus text
byte-equal, span names and parents equal, ledger integrals equal (the
ledger is the same pure-Python arithmetic, so exactly), each package's
validator accepting the other's JSONL and ``render(summarize_events())``
giving the same text on one stream.  The engine, the sessions and the
scheduler with telemetry attached are in
``tests/test_torch_telemetry_engine.py``."""
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.fault.monitor import PlacementMonitor as JMonitor
from repro.telemetry import (EnergyLedger as JLedger, Telemetry as JTel,
                             load_events as jload, render as jrender,
                             summarize_events as jsummarize,
                             validate_events as jvalidate)
from repro.telemetry.registry import _bucket_edge as j_bucket_edge
from repro_torch.core import solvers as ts
from repro_torch.fault import PlacementMonitor as TMonitor
from repro_torch.kernels import flash_attention as tfa, \
    placement_power as tpp
from repro_torch.telemetry import (EVENT_SCHEMA, EnergyLedger, Telemetry,
                                   load_events, render, summarize_events,
                                   validate_events)
from repro_torch.telemetry.registry import _bucket_edge

REPO = Path(__file__).resolve().parents[1]


def _spans(tel):
    return [(e["name"], e["parent"], e["ok"], e["err"], e["attrs"])
            for e in tel.events if e["type"] == "span"]


def _both(scenario):
    """Run ``scenario(tel)`` on a reference and a port registry; returns
    (reference, port)."""
    jt, tt = JTel(), Telemetry()
    scenario(jt)
    scenario(tt)
    return jt, tt


def _same_metrics(jt, tt):
    assert tt.counters == jt.counters
    assert tt.gauges == jt.gauges
    assert set(tt.hists) == set(jt.hists)
    for k, h in jt.hists.items():
        assert tt.hists[k].count == h.count
        if not k.startswith("span."):          # durations are wall time
            assert tt.hists[k].snapshot() == h.snapshot()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_nesting_parents():
    def scenario(tel):
        with tel.span("outer", r_bucket=4) as so:
            with tel.span("inner") as si:
                assert si.parent == so.id
            with tel.span("inner") as s2:
                assert s2.parent == so.id
        assert so.parent is None and not tel._span_stack

    jt, tt = _both(scenario)
    assert _spans(tt) == _spans(jt)
    assert tt.counters["span.outer"] == 1 and tt.counters["span.inner"] == 2
    _same_metrics(jt, tt)


def test_span_exception_safe():
    def scenario(tel):
        with pytest.raises(ValueError):
            with tel.span("boom"):
                raise ValueError("no")
        assert not tel._span_stack

    jt, tt = _both(scenario)
    assert _spans(tt) == _spans(jt) == [("boom", None, False, "ValueError",
                                         None)]
    assert tt.hists["span.boom.ms"].count == 1


def test_span_sync_on_cpu_is_a_noop():
    """``sp.sync`` returns its value and, for CPU tensors (alone or in a
    pytree), synchronizes nothing."""
    tel = Telemetry()
    x = torch.arange(8) * 2
    with tel.span("device") as sp:
        out = sp.sync(x)
        tree = sp.sync({"a": x, "b": (x + 1, None, 3.0)})
    assert out is x and int(out[-1]) == 14 and tree["b"][2] == 3.0
    with tel.span("plain", sync=x):
        pass
    assert tel.hists["span.device.ms"].count == 1
    assert tel.counters["span.plain"] == 1


# ---------------------------------------------------------------------------
# histograms and labels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v", [1.0, 1.5, 2.0, 2.1, 0.75, 0.5, 0.0, -3.0,
                               1e-6, 0.3, 7.0, 1234.5, 2.0 ** -20, 1e30])
def test_histogram_bucket_edges(v):
    """Exact powers of two land on their own edge, everything else rounds
    up to the next power of two, non-positive values pool at 0 -- the
    reference's edges."""
    e = _bucket_edge(v)
    assert e == j_bucket_edge(v)
    if v > 0:
        assert v <= e < 2 * v and math.frexp(e)[0] == 0.5


def test_histogram_stats_and_prometheus_byte_equal():
    def scenario(tel):
        for v in (1.0, 1.5, 2.0, 2.1, 100.0):
            tel.observe("lat.ms", v)
        tel.inc("waves", 3, region=1)
        tel.gauge("monitor.stranded_open", 2)
        with tel.span("work"):
            pass

    jt, tt = _both(scenario)
    h = tt.hists["lat.ms"]
    assert h.count == 5 and h.min == 1.0 and h.max == 100.0
    assert h.buckets == {1.0: 1, 2.0: 2, 4.0: 1, 128.0: 1}
    _same_metrics(jt, tt)
    # the span's duration histogram differs in its wall-clock buckets
    for tel in (jt, tt):
        del tel.hists["span.work.ms"]
    assert tt.prometheus() == jt.prometheus()
    assert 'repro_lat_ms_bucket{le="2.0"} 3' in tt.prometheus()


def test_metric_labels_flatten_sorted():
    def scenario(tel):
        tel.inc("waves", b="y", a=1)
        tel.inc("waves", a=1, b="y")
        tel.observe("lat", 3.0, z=2, y="q")

    jt, tt = _both(scenario)
    assert tt.counters == {"waves{a=1,b=y}": 2}
    _same_metrics(jt, tt)
    assert set(tt.hists) == {"lat{y=q,z=2}"}


# ---------------------------------------------------------------------------
# the JSONL stream, its schema and the CLI
# ---------------------------------------------------------------------------

def _write_run(Tel, path):
    with Tel(jsonl_path=str(path)) as tel:
        with tel.span("work", r_bucket=4):
            tel.inc("things")
        tel.ledger.set_tiers({"iot": [0], "cdc": [1, 2]})
        tel.ledger.tick(0.0, total_w=10.0, net_w=4.0, proc_w=6.0,
                        per_proc=[1.0, 2.0, 3.0], per_tenant={0: 4.0, 1: 6.0},
                        event="add")
        tel.ledger.tick(2.0, total_w=20.0, net_w=8.0, proc_w=12.0,
                        per_region={0: 15.0, "inter_region": 5.0})
        tel.emit("event", kind="node_failed", detail="p3", n=1)
        tel.emit("trace", entry="sweep", fingerprint="int32[8,2]")


def test_jsonl_roundtrip(tmp_path):
    path = tmp_path / "run.jsonl"
    _write_run(Telemetry, path)
    evs = load_events(str(path))
    assert validate_events(evs) == []
    assert evs[0]["type"] == "meta" and evs[0]["version"] == 1
    assert evs[-1]["type"] == "summary"
    s = summarize_events(evs)
    assert s["spans"]["work"]["count"] == 1
    # left-hold: 10 W held for 2 h = 72 kJ, the last sample extends nothing
    assert s["energy"]["joules_total"] == pytest.approx(10.0 * 2 * 3600)
    assert s["energy"]["joules_net"] == pytest.approx(4.0 * 2 * 3600)
    assert s["energy"]["joules_by_tier"] == {"iot": 7200.0, "cdc": 36000.0}
    assert s["monitor"] == {"node_failed": 1}
    assert s["compiles"] == {"sweep": 1}


def test_load_events_rejects_bad_lines(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"type": "meta", "ts": 0, "version": 1}\nnot json\n')
    for load in (load_events, jload):
        with pytest.raises(ValueError, match="bad JSON line"):
            load(str(path))


def test_validate_flags_missing_fields():
    bad = [{"type": "span", "ts": 1.0}, {"ts": 1.0},
           {"type": "solve", "ts": 0.0, "event": "add"},
           {"type": "energy", "ts": 0.0, "t": 0.0, "total_w": 1.0},
           {"type": "nope", "ts": 0.0}]
    problems = validate_events(bad)
    assert len(problems) == len(bad)
    assert problems == jvalidate(bad)


def test_event_schema_is_the_reference_schema():
    from repro.telemetry import EVENT_SCHEMA as JSCHEMA
    assert EVENT_SCHEMA == JSCHEMA


def test_cli_streams_cross_packages(tmp_path):
    """Each package's validator accepts the other's stream, and
    ``render(summarize_events())`` gives the same text for both packages
    on one stream."""
    tp_, jp_ = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    _write_run(Telemetry, tp_)
    _write_run(JTel, jp_)
    tev, jev = load_events(str(tp_)), jload(str(jp_))
    assert jvalidate(tev) == [] and validate_events(jev) == []
    for evs in (tev, jev):
        assert render(summarize_events(evs)) == jrender(jsummarize(evs))
    ts_, js_ = summarize_events(tev), summarize_events(jev)
    assert ts_["events_by_type"] == js_["events_by_type"]
    assert ts_["energy"] == js_["energy"]


def test_report_cli_roundtrip(tmp_path):
    path = tmp_path / "cli.jsonl"
    _write_run(Telemetry, path)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    run = lambda *args: subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry", *args],
        capture_output=True, text=True, env=env)
    out = run("validate", str(path))
    assert out.returncode == 0, out.stderr
    assert "0 schema problems" in out.stdout
    rep = json.loads(run("report", str(path), "--json").stdout)
    assert rep["spans"]["work"]["count"] == 1
    text = run("report", str(path)).stdout
    assert text.strip() == render(summarize_events(load_events(str(path))))
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "span", "ts": 1.0}\n')
    assert run("validate", str(bad)).returncode == 1


# ---------------------------------------------------------------------------
# energy ledger
# ---------------------------------------------------------------------------

TICKS = [(0.0, 100.0, 40.0, 60.0, [10.0, 50.0, 0.0], {0: 70.0, 1: 30.0},
          None),
         (1.0, 50.0, 20.0, 30.0, [0.0, 30.0, 0.0], None,
          {0: 20.0, 1: 25.0, "inter_region": 5.0}),
         (1.5, 80.0, 30.0, 50.0, [20.0, 10.0, 20.0], {1: 80.0}, None),
         (4.0, 10.0, 10.0, 0.0, [0.0, 0.0, 0.0], None, None)]


@pytest.mark.parametrize("t_end,hours", [(None, True), (6.0, True),
                                         (6.0, False)])
def test_ledger_integrate_equals_reference(t_end, hours):
    """The same ticks (tiers, tenant and region splits held between
    samples) integrate to the reference's joules exactly."""
    got, want = EnergyLedger(), JLedger()
    for led in (got, want):
        led.set_tiers({"iot": [0], "af": [1, 2]})
        for t, tot, net, proc, per_proc, ten, reg in TICKS:
            led.tick(t, tot, net, proc, per_proc=per_proc, per_tenant=ten,
                     per_region=reg, event="add")
    assert got.samples == want.samples
    out = got.integrate(t_end=t_end, hours=hours)
    assert out == want.integrate(t_end=t_end, hours=hours)
    assert out["joules_net"] + out["joules_proc"] == \
        pytest.approx(out["joules_total"])


def test_ledger_integration_left_hold():
    led = EnergyLedger()
    assert led.integrate()["samples"] == 0
    led.tick(0.0, total_w=100.0, net_w=40.0, proc_w=60.0)
    led.tick(1.0, total_w=50.0, net_w=20.0, proc_w=30.0)
    out = led.integrate(t_end=3.0)
    # 100 W for 1 h + 50 W for 2 h = 200 Wh = 720 kJ
    assert out["joules_total"] == pytest.approx(200.0 * 3600)
    assert out["joules_net"] == pytest.approx(80.0 * 3600)


# ---------------------------------------------------------------------------
# monitor delegation (the port's monitor mirrored into the port's registry)
# ---------------------------------------------------------------------------

def _monitor_script(mon):
    for _ in range(3):
        mon.count("admission_rejected", detail="sla")
    mon.count("node_failed", n=2)
    mon.strand(7, t=1.0)
    mon.unstrand(7, t=3.5)


def test_monitor_mirror_parity():
    """A mirrored port monitor keeps its standalone behaviour, and its
    registry holds the reference's mirrored counters and gauges."""
    plain, mirrored, tel = TMonitor(), TMonitor(), Telemetry()
    mirrored.attach_telemetry(tel)
    jmon, jtel = JMonitor(), JTel()
    jmon.attach_telemetry(jtel)
    for mon in (plain, mirrored, jmon):
        _monitor_script(mon)
    assert mirrored.snapshot() == plain.snapshot() == jmon.snapshot()
    assert mirrored.events == plain.events
    assert tel.counters == jtel.counters
    assert tel.gauges == jtel.gauges
    assert tel.counters["monitor.admission_rejected"] == 3
    assert tel.gauges["monitor.stranded_service_s"] == pytest.approx(2.5)


def test_monitor_ring_bound_unchanged_with_telemetry():
    tel = Telemetry()
    mon = TMonitor(max_events=4)
    mon.attach_telemetry(tel)
    for i in range(10):
        mon.count("k", detail=str(i))
    assert len(mon.events) == 4
    assert mon.counters["k"] == 10 and tel.counters["monitor.k"] == 10


def test_monitor_merge_no_double_count():
    tel = Telemetry()
    a, b = TMonitor(), TMonitor()
    a.attach_telemetry(tel)
    b.attach_telemetry(tel)        # same registry: counts already there
    a.count("x")
    b.count("x")
    a.merge(b)
    assert a.counters["x"] == 2 and tel.counters["monitor.x"] == 2
    c = TMonitor()                 # un-mirrored: merge must fold it in
    c.count("x", n=3)
    a.merge(c)
    assert a.counters["x"] == 5 and tel.counters["monitor.x"] == 5


# ---------------------------------------------------------------------------
# shape and launch attribution (the port's counterpart of compile
# attribution: tests/test_telemetry.py::test_compile_attribution_agrees)
# ---------------------------------------------------------------------------

def test_trace_counts_tick_once_per_fingerprint():
    """``count_traces`` ticks once per fresh abstract shape fingerprint:
    a second call at the same shapes is no trace, a new shape or a new
    static value is one, and every hook sees the fresh ones."""
    seen = []

    @ts.count_traces("probe_entry")
    def probe(x, positions, n: int, eligible=None):
        return x.sum()

    ts.TRACE_HOOKS.append(lambda e, fp: seen.append((e, fp)))
    try:
        probe(torch.zeros(4, 3), np.zeros((8, 2), np.int64), 2)
        probe(torch.ones(4, 3), np.ones((8, 2), np.int64), 2)
        assert ts.TRACE_COUNTS["probe_entry"] == 1
        probe(torch.zeros(8, 3), np.zeros((8, 2), np.int64), 2)
        probe(torch.zeros(8, 3), np.zeros((8, 2), np.int64), 3)
        probe(torch.zeros(8, 3), np.zeros((8, 2), np.int64), 3,
              eligible=torch.ones(8, 5, dtype=torch.bool))
    finally:
        ts.TRACE_HOOKS.pop()
    assert ts.TRACE_COUNTS["probe_entry"] == 4
    assert [fp for _, fp in seen] == [
        "float32[4,3];int64[8,2];int(2)", "float32[8,3];int64[8,2];int(2)",
        "float32[8,3];int64[8,2];int(3)",
        "float32[8,3];int64[8,2];int(3);bool[8,5]"]


def test_attribution_agrees_and_detaches():
    """``report()["compiles"]`` and ``report()["launches"]`` agree with
    the live ``TRACE_COUNTS`` and ``LAUNCHES`` deltas (launches mirrored
    as ``launch.<kernel>`` counters; none on the CPU unless a wrapper
    counts one), and ``close`` detaches every hook."""
    tel = Telemetry()
    tel.attach_traces()

    @ts.count_traces("probe_attr")
    def probe(x):
        return x

    probe(torch.zeros(3))
    probe(torch.zeros(5))
    rep = tel.report()
    assert rep["compiles"]["agree"] is True
    assert rep["compiles"]["recorded"] == {"probe_attr": 2}
    assert rep["launches"] == {"recorded": {}, "live": {}, "agree": True}
    for rec in tel.compile_attribution():
        assert "[" in rec["fingerprint"]
    before = dict(tpp.LAUNCHES)
    tpp._count_launch("placement_power")     # one counted launch
    rep = tel.report()
    assert rep["launches"]["recorded"] == {"placement_power": 1}
    assert rep["launches"]["agree"] is True
    assert tel.counters["launch.placement_power"] == 1
    tpp.LAUNCHES.update(before)
    tel.close()
    assert tel._trace_hook is None and tel._launch_hook is None
    assert not ts.TRACE_HOOKS and not tpp.LAUNCH_HOOKS \
        and not tfa.LAUNCH_HOOKS


# ---------------------------------------------------------------------------
# the package lints clean
# ---------------------------------------------------------------------------

def test_telemetry_package_tracelint_clean():
    from repro.analysis import analyze_paths
    findings = analyze_paths([str(REPO / "src" / "repro_torch" /
                                  "telemetry")])
    assert findings == [], [f"{f.rule}:{f.path}:{f.line}" for f in findings]


def test_telemetry_package_imports_no_jax():
    code = ("import sys; import repro_torch.telemetry, "
            "repro_torch.telemetry.__main__; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_federated_trace_counts_against_jax():
    """The counted entries on a federated solve and add (the reference's
    fixture, the "quick" batched effort, both caches cleared): equal
    to the reference's jit traces but for ``sweep``, which the reference
    also traces once inside its jitted ``solve_regions``; the port's
    lockstep sweep vmaps the uncounted ``_sweep_step`` instead."""
    import jax
    from repro.api import FederatedSession as JFed, PlacementSpec as JSpec
    from repro.core import solvers as js, topology as jtopo, vsr as jvsr
    from repro_torch.api import FederatedSession as TFed, \
        PlacementSpec as TSpec
    from repro_torch.core import federation as tfed, topology as ttopo, \
        vsr as tvsr
    fed = dict(n_regions=3, n_olt=1, onus_per_olt=2, iot_per_onu=2,
               n_core=6)
    kw = dict(effort="quick", anneal_steps=0, defrag_every=0)
    tt = ttopo.federated_scale(**fed)
    srcs = [int(r.proc_ids[0])
            for r in tfed.RegionPartition.from_topology(tt).regions]

    def fresh(counts, before):
        return {k: v - before.get(k, 0) for k, v in counts.items()
                if v != before.get(k, 0)}

    jax.clear_caches()
    before = dict(js.TRACE_COUNTS)
    j = JFed(jtopo.federated_scale(**fed), JSpec(**kw),
             key=jax.random.PRNGKey(3))
    j.solve(jvsr.random_vsrs(6, rng=1, n_vms=3, source_nodes=srcs))
    j.add(jvsr.random_vsrs(1, rng=9, n_vms=3, source_nodes=[srcs[1]]))
    want = fresh(js.TRACE_COUNTS, before)
    ts.clear_trace_cache()
    before = dict(ts.TRACE_COUNTS)
    t = TFed(tt, TSpec(**kw), device="cpu")
    t.solve(tvsr.random_vsrs(6, rng=1, n_vms=3, source_nodes=srcs))
    t.add(tvsr.random_vsrs(1, rng=9, n_vms=3, source_nodes=[srcs[1]]))
    got = fresh(ts.TRACE_COUNTS, before)
    assert got["solve_regions"] == want["solve_regions"] == 1
    assert got["sweep"] == want["sweep"] - 1 > 0
    assert set(got) == set(want)
