"""Solvers of the PyTorch port against the JAX package, on the CPU.

Deterministic solvers must agree exactly (fixed_layer placements byte-equal,
exhaustive objectives equal) or to float32 tolerance (coordinate objectives
within rtol 1e-6; identical IoT nodes make exact ties common, so placements
are not compared).  Stochastic solvers cannot share a random stream with
JAX, so the Metropolis loop runs on the reference's own proposal streams
and its best objective must agree within 5e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PlacementSpec as JSpec
from repro.core import power as jp, solvers as js, topology as jtopo, \
    vsr as jvsr
from repro_torch.api import PlacementSpec as TSpec
from repro_torch.core import power as tp, solvers as ts, topology as ttopo, \
    vsr as tvsr


@pytest.fixture(scope="module")
def paper():
    jt, tt = jtopo.paper_topology(), ttopo.paper_topology()
    kw = dict(rng=0, source_nodes=[0])
    return (jt, tt, jp.build_problem(jt, jvsr.random_vsrs(10, **kw)),
            tp.build_problem(tt, tvsr.random_vsrs(10, **kw), device="cpu"))


@pytest.fixture(scope="module")
def city():
    kw = dict(n_olt=2, onus_per_olt=4, iot_per_onu=8)
    jt, tt = jtopo.city_scale(**kw), ttopo.city_scale(**kw)
    vkw = dict(rng=1, source_nodes=[0, 9, 17, 40])
    return (jt, tt, jp.build_problem(jt, jvsr.random_vsrs(12, **vkw)),
            tp.build_problem(tt, tvsr.random_vsrs(12, **vkw), device="cpu"))


@pytest.mark.parametrize("layer", ["cdc", "af", "mf", "iot"])
@pytest.mark.parametrize("scale", ["paper", "city"])
def test_fixed_layer_byte_equal(layer, scale, request):
    jt, tt, jprob, tprob = request.getfixturevalue(scale)
    a = js.fixed_layer(jprob, jt, layer)
    b = ts.fixed_layer(tprob, tt, layer)
    assert a.X.dtype == b.X.dtype and a.X.tobytes() == b.X.tobytes()
    assert b.method == a.method
    assert b.objective == pytest.approx(a.objective, rel=2e-5, abs=1e-2)
    assert b.feasible == a.feasible


@pytest.mark.parametrize("max_hops", [None, 2])
@pytest.mark.parametrize("scale", ["paper", "city"])
def test_coordinate_matches_jax(max_hops, scale, request):
    jt, tt, jprob, tprob = request.getfixturevalue(scale)
    X0 = np.full((tprob.R, tprob.V), tt.layer_indices("cdc")[0], np.int32)
    el_j = JSpec(max_hops=max_hops).masks(jprob)
    el_t = TSpec(max_hops=max_hops).masks(tprob)
    if max_hops is None:
        assert el_j is None and el_t is None
    else:
        np.testing.assert_array_equal(el_t, el_j)
    a = js.coordinate(jprob, X0, eligible=el_j)
    b = ts.coordinate(tprob, X0, eligible=el_t)
    assert b.objective == pytest.approx(a.objective, rel=1e-6)
    if el_t is not None:
        fixed = tprob.fixed_mask.numpy()
        rows = np.arange(tprob.R)[:, None]
        assert np.all(el_t[rows, b.X] | fixed)
    assert all(h2 <= h1 for h1, h2 in zip(b.history, b.history[1:]))


SOLVER_GAP_SEEDS = (0, 1, 2, 3, 4)


def _gap_instance(seed):
    """benchmarks/paper_figures.py solver_gap: 4 IoT nodes in 2 zones, two
    2-VM services."""
    jt = jtopo.paper_topology(n_iot=4, n_zones=2)
    tt = ttopo.paper_topology(n_iot=4, n_zones=2)
    kw = dict(rng=seed, n_vms=2, source_nodes=[0])
    return (jt, tt, jp.build_problem(jt, jvsr.random_vsrs(2, **kw)),
            tp.build_problem(tt, tvsr.random_vsrs(2, **kw), device="cpu"))


@pytest.mark.parametrize("seed", SOLVER_GAP_SEEDS)
def test_exhaustive_matches_jax(seed):
    _, _, jprob, tprob = _gap_instance(seed)
    a = js.exhaustive(jprob)
    b = ts.exhaustive(tprob)
    assert b.objective == pytest.approx(a.objective, rel=1e-6)
    assert b.history[0] == pytest.approx(a.history[0], rel=1e-6)


def test_exhaustive_respects_mask():
    _, _, _, tprob = _gap_instance(0)
    el = np.zeros((tprob.R, tprob.P), bool)
    el[:, 1] = True
    res = ts.exhaustive(tprob, eligible=el)
    assert np.all(res.X[~tprob.fixed_mask.numpy()] == 1)


@pytest.mark.parametrize("scale", ["paper", "city"])
def test_anneal_delta_on_reference_streams(scale, request):
    """The delta Metropolis loop on the reference's proposal streams finds
    the reference's best objective (within 5e-2)."""
    _, _, jprob, tprob = request.getfixturevalue(scale)
    jaux, taux = jp.build_aux(jprob), tp.build_aux(tprob)
    C, T = 8, 300
    rng = np.random.default_rng(5)
    Xc = np.asarray(jax.vmap(lambda x: jp.apply_pins(jprob, x))(jnp.asarray(
        rng.integers(0, jprob.P, (C, jprob.R, jprob.V)), jnp.int32)))
    fi, p, u = js._anneal_proposals(jax.random.PRNGKey(2), jaux, T, C,
                                    jprob.P)
    j = np.asarray(jaux.free_flat[fi])
    temps = (5.0 * (0.05 / 5.0) ** (np.arange(T) / (T - 1))).astype(
        np.float32)
    jX, jobj, _ = js._anneal_scan_delta(jprob, jaux, jnp.asarray(Xc),
                                        jnp.asarray(j), p, u,
                                        jnp.asarray(temps))
    tX, tobj, (best, acc) = ts._anneal_scan_delta(
        tprob, taux, Xc, j, np.asarray(p), np.asarray(u), temps)
    assert abs(float(tobj) - float(jobj)) <= 5e-2
    assert float(tp.objective(tprob, tX)) == pytest.approx(float(tobj),
                                                           rel=1e-5, abs=5e-2)
    assert best.shape == (T,) and acc.shape == (T,)
    assert torch.all(best[1:] <= best[:-1])
    # the same streams through anneal()'s injection point
    res = ts.anneal(tprob, ts.default_generator(0), Xc[0], n_chains=C,
                    n_steps=T, t0=5.0, backend="delta",
                    proposals=(np.asarray(fi), np.asarray(p), np.asarray(u)),
                    record_conv=True)
    assert res.conv["best_obj"].shape == (T,)
    assert res.objective <= float(tp.objective(tprob, Xc[0])) + 1e-3


def test_anneal_backends_agree(paper):
    """One generator seed, one proposal stream: the delta and full
    backends end on the same placement, and the fused backend (its plain
    version on the CPU) on the same objective."""
    _, tt, _, tprob = paper
    X0 = ts.fixed_layer(tprob, tt, "iot").X
    kw = dict(n_chains=8, n_steps=300)
    res = {b: ts.anneal(tprob, ts.default_generator(3), X0, backend=b, **kw)
           for b in ("delta", "full", "fused")}
    np.testing.assert_array_equal(res["delta"].X, res["full"].X)
    assert res["fused"].objective == pytest.approx(res["delta"].objective,
                                                   abs=5e-2)
    assert res["fused"].method == "anneal(fused)"
    auto = ts.anneal(tprob, ts.default_generator(3), X0, **kw)
    assert auto.method == "anneal"          # "auto" is delta on the CPU


def test_anneal_masked_stays_eligible(city):
    _, tt, _, tprob = city
    el = TSpec(max_hops=3).masks(tprob)
    X0 = np.full((tprob.R, tprob.V), tt.layer_indices("cdc")[0], np.int32)
    fixed = tprob.fixed_mask.numpy()
    rows = np.arange(tprob.R)[:, None]
    for backend in ("delta", "fused"):
        res = ts.anneal(tprob, ts.default_generator(1), X0, n_chains=4,
                        n_steps=200, backend=backend, eligible=el)
        assert np.all(el[rows, res.X] | fixed), backend


def test_genetic_respects_mask_and_improves(paper):
    _, tt, _, tprob = paper
    X0 = ts.fixed_layer(tprob, tt, "cdc").X
    el = TSpec(max_hops=4).masks(tprob)
    res = ts.genetic(tprob, ts.default_generator(0), X0, pop=16, gens=30,
                     eligible=el)
    fixed = tprob.fixed_mask.numpy()
    assert np.all(el[np.arange(tprob.R)[:, None], res.X] | fixed)
    start = ts._result(tprob, ts._project_eligible(tprob, X0, el)[0], "x")
    assert res.objective <= start.objective + 1e-3


@pytest.mark.parametrize("scale", ["paper", "city"])
def test_portfolio_quick_matches_jax(scale, request):
    jt, tt, jprob, tprob = request.getfixturevalue(scale)
    a = js.solve_portfolio(jprob, jt, JSpec(effort="quick"))
    b = ts.solve_portfolio(tprob, tt, TSpec(effort="quick"))
    assert b.objective == pytest.approx(a.objective, rel=1e-6)
    assert b.method.startswith("cfn-milp(")


def test_repair_to_eligible_matches_jax(paper):
    jt, tt, jprob, tprob = paper
    base_j = js.fixed_layer(jprob, jt, "cdc")
    base_t = ts.fixed_layer(tprob, tt, "cdc")
    el = TSpec(max_hops=2).masks(tprob)
    a = js.repair_to_eligible(jprob, base_j, el)
    b = ts.repair_to_eligible(tprob, base_t, el)
    assert b.objective == pytest.approx(a.objective, rel=1e-6)
    unmasked = np.ones_like(el)
    assert ts.repair_to_eligible(tprob, base_t, unmasked) is base_t


def test_eligible_helpers_match_jax():
    rng = np.random.default_rng(0)
    el = rng.random((5, 9)) < 0.3
    el[1] = False
    for a, b in zip(js._eligible_np(el), ts._eligible_np(el)):
        np.testing.assert_array_equal(a, b)
    _, cnt, cand = ts._eligible_np(el)
    u = rng.random((7, 5)).astype(np.float32)
    rows = np.arange(5)[None, :].repeat(7, 0)
    want = np.asarray(js._sample_eligible(jnp.asarray(u), jnp.asarray(rows),
                                          jnp.asarray(cnt),
                                          jnp.asarray(cand)))
    got = ts._sample_eligible(torch.as_tensor(u), torch.as_tensor(rows),
                              torch.as_tensor(cnt), torch.as_tensor(cand))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pow2_and_relax():
    assert [ts._pow2(n) for n in (0, 1, 2, 3, 5, 16, 17)] == \
        [js._pow2(n) for n in (0, 1, 2, 3, 5, 16, 17)]
    assert ts._pow2(3, lo=8) == 8
    # relax (200 steps) on the reference's starting logits: the loss
    # history within rtol 1e-3, the repaired placement equal
    kw = dict(rng=2, n_vms=2, source_nodes=[0])
    jt = jtopo.paper_topology(n_iot=4, n_zones=2)
    tt = ttopo.paper_topology(n_iot=4, n_zones=2)
    jprob = jp.build_problem(jt, jvsr.random_vsrs(2, **kw))
    tprob = tp.build_problem(tt, tvsr.random_vsrs(2, **kw), device="cpu")
    key = jax.random.PRNGKey(2)
    want = js.relax(jprob, key, steps=200)
    got = ts.relax(tprob, None, steps=200, logits0=np.asarray(
        0.01 * jax.random.normal(key, (tprob.R, tprob.V, tprob.P))))
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3)
    np.testing.assert_array_equal(got.X, want.X)
    assert got.method == "relax"
