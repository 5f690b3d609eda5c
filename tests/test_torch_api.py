"""The user surface of the PyTorch port (``repro_torch.api``) against the JAX
package's: the quickstart session, the portfolio's zero gap to exhaustive
enumeration, spec validation and masks, device selection, and import
purity (the port loads neither JAX nor the JAX package)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import CFNSession as JSession, PlacementSpec as JSpec
from repro.core import power as jp, topology as jtopo, vsr as jvsr
from repro_torch.api import CFNSession, PlacementSpec, SubstrateHealth
from repro_torch.core import embed, power as tp, solvers as ts, \
    topology as ttopo, vsr as tvsr
from repro_torch.telemetry import Telemetry, tiers_of

REPO = Path(__file__).resolve().parents[1]
QUICK = dict(method="cfn-milp", bucket_rows=False, bucket_cols=False)
BASELINES = ("cdc", "af", "mf")


def _quickstart(session_cls, spec_cls, topo, vsrs, **kw):
    spec = spec_cls(**QUICK)
    out = {"cfn-milp": session_cls(topo, spec, **kw).solve(vsrs)}
    for pol in BASELINES:
        out[pol] = session_cls(topo, spec.replace(method=pol), **kw).solve(
            vsrs)
    return out


@pytest.fixture(scope="module")
def quickstart():
    """examples/quickstart.py on both packages: paper topology, 10 VSRs
    from seed 0 at IoT node 0, cfn-milp at standard effort, bucketing off."""
    ref = _quickstart(JSession, JSpec, jtopo.paper_topology(),
                      jvsr.random_vsrs(10, rng=0, source_nodes=[0]))
    port = _quickstart(CFNSession, PlacementSpec, ttopo.paper_topology(),
                       tvsr.random_vsrs(10, rng=0, source_nodes=[0]),
                       device="cpu")
    return ref, port


def test_quickstart_power_matches_jax(quickstart):
    ref, port = quickstart
    res = port["cfn-milp"]
    assert res.feasible
    assert res.method.startswith("cfn-milp(")
    assert res.power == pytest.approx(ref["cfn-milp"].power, rel=0.01)
    assert set(ttopo.paper_topology().proc_layer[p]
               for p in res.X.reshape(-1)) <= {"iot", "cdc"}


@pytest.mark.parametrize("pol", BASELINES)
def test_quickstart_savings_match_jax(quickstart, pol):
    ref, port = quickstart
    assert port[pol].X.tobytes() == ref[pol].X.tobytes()
    saving = 1 - port["cfn-milp"].power / port[pol].power
    want = 1 - ref["cfn-milp"].power / ref[pol].power
    assert abs(saving - want) <= 0.01
    assert 0.19 <= saving <= 0.91                  # the paper's band


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_cfn_milp_zero_gap_to_exhaustive(seed):
    """benchmarks/paper_figures.py solver_gap instances: the portfolio
    finds the enumerated optimum."""
    topo = ttopo.paper_topology(n_iot=4, n_zones=2)
    vs = tvsr.random_vsrs(2, rng=seed, n_vms=2, source_nodes=[0])
    prob = tp.build_problem(topo, vs, device="cpu")
    best = ts.exhaustive(prob)
    res = embed.embed(topo, vs, spec=PlacementSpec(), problem=prob,
                      gen=ts.default_generator(seed))
    gap = (res.objective - best.objective) / max(best.objective, 1e-9)
    assert gap <= 1e-6


def test_session_with_buckets_matches_jax():
    """Row and column bucketing (the session default) pads the problem to
    power-of-two shapes without changing the objective."""
    kw = dict(rng=4, n_vms=3, source_nodes=[0, 5])
    jv, tv = jvsr.random_vsrs(5, **kw), tvsr.random_vsrs(5, **kw)
    jres = JSession(jtopo.paper_topology(), JSpec(effort="quick")).solve(jv)
    sess = CFNSession(ttopo.paper_topology(), PlacementSpec(effort="quick"),
                      device="cpu")
    res = sess.solve(tv)
    assert (sess.problem.R, sess.problem.V) == (8, 4)
    assert sess.n_live == 5
    assert res.objective == pytest.approx(jres.objective, rel=1e-6)
    assert sess.objective() == res.objective
    assert sess.power_w() == res.power
    np.testing.assert_array_equal(sess.X, res.X)
    with pytest.raises(ValueError):
        sess.solve(tv)


def test_session_savings_vs_baseline():
    topo = ttopo.paper_topology()
    vs = tvsr.random_vsrs(6, rng=2, source_nodes=[0])
    sess = CFNSession(topo, PlacementSpec(effort="quick"), device="cpu")
    sess.solve(vs)
    out = sess.savings_vs_baseline("cdc")
    assert out["optimized_w"] < out["baseline_w"]
    assert out["saving_frac"] == pytest.approx(
        1 - out["optimized_w"] / out["baseline_w"])
    ref = JSession(jtopo.paper_topology(), JSpec(effort="quick"))
    ref.solve(jvsr.random_vsrs(6, rng=2, source_nodes=[0]))
    want = ref.savings_vs_baseline("cdc")
    assert out["saving_frac"] == pytest.approx(want["saving_frac"],
                                               abs=1e-6)


def test_module_savings_vs_baseline_matches_jax():
    from repro.core import embed as jembed
    kw = dict(rng=3, source_nodes=[0])
    want = jembed.savings_vs_baseline(jtopo.paper_topology(),
                                      jvsr.random_vsrs(4, **kw),
                                      baseline="mf", method="coordinate")
    got = embed.savings_vs_baseline(ttopo.paper_topology(),
                                    tvsr.random_vsrs(4, **kw),
                                    baseline="mf", method="coordinate",
                                    device="cpu")
    assert got["baseline_w"] == pytest.approx(want["baseline_w"], rel=2e-5)
    assert got["optimized_w"] == pytest.approx(want["optimized_w"],
                                               rel=1e-6)
    assert got["saving_frac"] == pytest.approx(want["saving_frac"],
                                               abs=1e-6)


def test_masked_session_keeps_hop_bound():
    topo = ttopo.paper_topology()
    vs = tvsr.random_vsrs(6, rng=1, source_nodes=[0, 7])
    spec = PlacementSpec(max_hops=2, effort="quick")
    sess = CFNSession(topo, spec, device="cpu")
    res = sess.solve(vs)
    src = np.asarray(vs.src)
    for r in range(vs.R):
        assert np.all(topo.path_hops[src[r], res.X[r]] <= 2)
    jspec = JSpec(max_hops=2, effort="quick")
    jprob = jp.build_problem(jtopo.paper_topology(), jvsr.random_vsrs(
        6, rng=1, source_nodes=[0, 7]), pad_to_rows=8, pad_to_cols=4)
    np.testing.assert_array_equal(sess.masks(), jspec.masks(jprob))


def test_spec_validation():
    for bad in (dict(method="milp"), dict(effort="max"),
                dict(backend="tpu"), dict(row_bucket_lo=0),
                dict(priority_classes=0), dict(defrag_rows_per_tick=-1)):
        with pytest.raises(ValueError):
            PlacementSpec(**bad)
    topo = ttopo.paper_topology()
    health = SubstrateHealth.fresh(topo).fail_node(3)
    assert PlacementSpec(health=health).health is health
    tel = Telemetry()
    sess = CFNSession(topo, PlacementSpec(method="coordinate",
                                          anneal_steps=0),
                      device="cpu", telemetry=tel)
    assert sess.telemetry is tel and tel.ledger.tiers == tiers_of(topo)
    sess.add(tvsr.random_vsrs(1, rng=0, source_nodes=[0]))
    assert [e["name"] for e in tel.events if e["type"] == "span"] == ["add"]
    assert len(tel.ledger.samples) == 1
    assert tel.ledger.samples[0]["total_w"] == pytest.approx(sess.power_w())
    assert PlacementSpec().replace(max_hops=3).max_hops == 3


def test_unported_session_paths_raise():
    """``solve()`` with no batch, once unported, now re-packs the live set
    (a full solve kept only where it beats the live placement, so it never
    regresses) and raises ValueError on an empty session; the relax
    method, once unported, returns a placement (its parity with the JAX
    package is held in tests/test_torch_relax.py).  The churn path's
    parity is held in tests/test_torch_online.py."""
    topo = ttopo.paper_topology()
    sess = CFNSession(topo, PlacementSpec(effort="quick"), device="cpu")
    with pytest.raises(ValueError, match="empty session"):
        sess.solve()
    first = sess.solve(tvsr.random_vsrs(5, rng=6, source_nodes=[0]))
    again = sess.solve()
    assert again.objective <= first.objective + 1e-6
    assert [s.event for s in sess.stats] == ["bootstrap", "defrag"]
    assert sess.objective() == again.objective and sess.n_live == 5
    vsrs = tvsr.random_vsrs(2)
    res = CFNSession(ttopo.paper_topology(), PlacementSpec(method="relax"),
                     device="cpu").solve(vsrs)
    assert res.method == "relax" and res.X.shape[0] >= vsrs.R
    assert np.isfinite(res.objective) and res.feasible


def test_session_solve_is_embed_with_seed1_generator():
    """``solve(vsrs)`` goes through the online engine's bootstrap and gives
    what ``embed._embed`` gives on the same bucket-padded problem with a
    fresh seed-1 generator (the session's default): the same X, method
    and objective."""
    topo = ttopo.paper_topology()
    vs = tvsr.random_vsrs(5, rng=8, source_nodes=[0, 4])
    spec = PlacementSpec()
    res = CFNSession(topo, spec, device="cpu").solve(vs)
    prob = tp.build_problem(topo, vs, pad_to_rows=8, pad_to_cols=4,
                            device="cpu")
    want = embed._embed(topo, vs, spec, gen=ts.default_generator(1),
                        problem=prob)
    np.testing.assert_array_equal(res.X, want.X)
    assert res.method == want.method
    assert res.objective == want.objective


def test_default_device_is_cuda():
    """Without ``device=`` the session runs on the CUDA card, and says so
    when there is none."""
    topo = ttopo.paper_topology()
    if torch.cuda.is_available():
        assert CFNSession(topo).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CFNSession(topo)
    with pytest.raises(RuntimeError):
        tp.build_problem(topo, tvsr.random_vsrs(2))


def test_import_purity():
    """Importing the port loads neither jax nor the JAX package."""
    code = ("import sys, repro_torch, repro_torch.api, "
            "repro_torch.kernels.ops, repro_torch.core.embed, "
            "repro_torch.core.dynamic, repro_torch.core.solvers, "
            "repro_torch.core.federation, repro_torch.paper_figures, "
            "repro_torch.configs, repro_torch.models.model, "
            "repro_torch.models.costs, repro_torch.serve.engine, "
            "repro_torch.serve.cache\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(REPO / "src"),
                                       "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_never_import_jax():
    for path in (REPO / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for line in text.splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), path
            assert not s.startswith(("import repro.", "from repro.",
                                     "from repro import")), path
