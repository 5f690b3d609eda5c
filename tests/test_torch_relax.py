"""The relaxation path of the PyTorch port against the JAX package, on the
CPU: the soft power surrogate (``evaluate(hard=False)``) and its gradient,
``relax`` fed the reference's starting logits, and the two deprecated
shims (``solvers.solve_cfn``, ``embed.embed_latency_bounded``).

Tolerances: the soft surrogate rtol 1e-5 (float32 sums in another order)
and its gradient rtol 1e-4 of the largest entry (the backward pass sums
in yet another order); the relax loss history rtol 1e-3 over 800 Adam
steps; placements after the repair equal, and where float order alone
makes one differ (the hop-masked quickstart, whose mask leaves equal-cost
nodes), its objective within 1e-4 relative."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PlacementSpec as JSpec
from repro.core import embed as jembed, power as jp, solvers as js, \
    topology as jtopo, vsr as jvsr
from repro_torch.api import PlacementSpec as TSpec
from repro_torch.core import embed as tembed, power as tp, \
    solvers as ts, topology as ttopo, vsr as tvsr

CITY = dict(n_olt=2, onus_per_olt=4, iot_per_onu=8)


def _quiet(fn, *a, **kw):
    """Call a deprecated shim: it must warn, and the warning stays here."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(*a, **kw)
    assert any(issubclass(w.category, DeprecationWarning) for w in rec)
    return out


def _pair(scale, n_vsrs, **kw):
    if scale == "paper":
        jt, tt = jtopo.paper_topology(), ttopo.paper_topology()
    elif scale == "gap":     # solver_gap's substrate
        jt = jtopo.paper_topology(n_iot=4, n_zones=2)
        tt = ttopo.paper_topology(n_iot=4, n_zones=2)
    else:
        jt, tt = jtopo.city_scale(**CITY), ttopo.city_scale(**CITY)
    return (jt, tt, jp.build_problem(jt, jvsr.random_vsrs(n_vsrs, **kw)),
            tp.build_problem(tt, tvsr.random_vsrs(n_vsrs, **kw),
                             device="cpu"))


# ---------------------------------------------------------------------------
# The soft surrogate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temp", [5.0, 0.05])
@pytest.mark.parametrize("scale", ["paper", "city"])
def test_soft_evaluate_and_gradient_match_jax(scale, temp):
    """Random softmax assignments: every field of the breakdown, and the
    gradient of power + 7 x violation (both branches of the loss) with
    respect to the assignment, jax.grad against torch.autograd."""
    _, _, jprob, tprob = _pair(scale, 10, rng=0, source_nodes=[0, 1])
    rng = np.random.default_rng(1)
    lg = 3.0 * rng.normal(size=(tprob.R, tprob.V, tprob.P))
    soft = (np.exp(lg) / np.exp(lg).sum(-1, keepdims=True)).astype(
        np.float32)

    def jloss(x):
        bd = jp.evaluate(jprob, x, hard=False, temp=temp)
        return bd.total + 7.0 * bd.violation

    want = jp.evaluate(jprob, jnp.asarray(soft), hard=False, temp=temp)
    gj = np.asarray(jax.grad(jloss)(jnp.asarray(soft)))
    x = torch.tensor(soft, requires_grad=True)
    got = tp.evaluate(tprob, x, hard=False, temp=temp)
    (got.total + 7.0 * got.violation).backward()
    for name in ("total", "net", "proc", "violation", "per_proc",
                 "per_net", "omega"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    g = x.grad.numpy()
    np.testing.assert_allclose(g, gj, rtol=1e-4,
                               atol=1e-4 * np.abs(gj).max())


def test_soft_evaluate_batch_is_per_candidate():
    """``evaluate_batch(hard=False)`` over a leading batch axis equals the
    single-candidate surrogate of each, and a one-hot assignment gives
    the hard loads."""
    _, tt, _, tprob = _pair("city", 6, rng=2, source_nodes=[0, 1])
    rng = np.random.default_rng(2)
    lg = torch.as_tensor(rng.normal(size=(3, tprob.R, tprob.V, tprob.P)),
                         dtype=torch.float32)
    soft = torch.softmax(lg, -1)
    batch = tp.evaluate_batch(tprob, soft, hard=False, temp=0.5)
    for b in range(3):
        one = tp.evaluate(tprob, soft[b], hard=False, temp=0.5)
        for name in ("total", "violation", "per_net", "omega"):
            torch.testing.assert_close(getattr(batch, name)[b],
                                       getattr(one, name),
                                       rtol=1e-5, atol=1e-5)
    X = tp.apply_pins(tprob, rng.integers(0, tprob.P, (tprob.R, tprob.V)))
    onehot = torch.nn.functional.one_hot(X.long(), tprob.P).float()
    soft_oh = tp.evaluate(tprob, onehot, hard=False)
    hard = tp.evaluate(tprob, X)
    torch.testing.assert_close(soft_oh.omega, hard.omega)
    torch.testing.assert_close(soft_oh.violation, hard.violation,
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# relax, on the reference's starting logits
# ---------------------------------------------------------------------------

RELAX_CASES = {
    **{f"gap_seed{s}": ("gap", dict(n_vsrs=2, rng=s, n_vms=2,
                                    source_nodes=[0]), s) for s in range(5)},
    "quickstart": ("paper", dict(n_vsrs=10, rng=0, source_nodes=[0]), 0),
}


def _relax_pair(case, max_hops=None):
    scale, kw, seed = RELAX_CASES[case]
    kw = dict(kw)
    n = kw.pop("n_vsrs")
    _, _, jprob, tprob = _pair(scale, n, **kw)
    key = jax.random.PRNGKey(seed)
    want = js.relax(jprob, key, eligible=JSpec(max_hops=max_hops).masks(
        jprob))
    logits0 = np.asarray(0.01 * jax.random.normal(
        key, (tprob.R, tprob.V, tprob.P)))
    got = ts.relax(tprob, None, eligible=TSpec(max_hops=max_hops).masks(
        tprob), logits0=logits0)
    return tprob, want, got


@pytest.mark.parametrize("case", sorted(RELAX_CASES))
def test_relax_matches_jax(case):
    """The five solver_gap instances and the quickstart: the loss history
    (every 20th of 800 steps, then the repair's) within rtol 1e-3 and the
    repaired placement equal."""
    _, want, got = _relax_pair(case)
    assert got.method == want.method == "relax"
    assert len(got.history) == len(want.history)
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3)
    np.testing.assert_array_equal(got.X, want.X)
    assert got.objective == pytest.approx(want.objective, rel=1e-5)


@pytest.mark.parametrize("case,max_hops", [("gap_seed0", 1),
                                           ("gap_seed3", 1),
                                           ("quickstart", 2)])
def test_relax_eligible_matches_jax(case, max_hops):
    """With a ``max_hops`` mask: the history within rtol 1e-3, every VM
    within the hop limit, and the placement equal -- or, on the
    quickstart, whose 2-hop mask leaves nodes of equal cost that float
    order alone picks between, the objective within 1e-4 relative."""
    tprob, want, got = _relax_pair(case, max_hops)
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3)
    el = TSpec(max_hops=max_hops).masks(tprob)
    free = ~tprob.fixed_mask.numpy()
    assert el[np.arange(tprob.R)[:, None], got.X][free].all()
    if case == "quickstart":
        assert got.objective == pytest.approx(want.objective, rel=1e-4)
    else:
        np.testing.assert_array_equal(got.X, want.X)


def test_relax_draws_its_own_logits():
    """Without ``logits0`` relax draws them from its generator: the same
    seed gives the same result, and the solve is a repaired placement no
    worse than 4 coordinate sweeps' bound allows (finite, pins kept)."""
    tt = ttopo.paper_topology()
    prob = tp.build_problem(tt, tvsr.random_vsrs(4, rng=3,
                                                 source_nodes=[0]),
                            device="cpu")
    a = ts.relax(prob, ts.default_generator(5), steps=60)
    b = ts.relax(prob, ts.default_generator(5), steps=60)
    np.testing.assert_array_equal(a.X, b.X)
    assert a.history == b.history and np.isfinite(a.history).all()
    fm = prob.fixed_mask.numpy()
    np.testing.assert_array_equal(a.X[fm], prob.fixed_node.numpy()[fm])


# ---------------------------------------------------------------------------
# The deprecated shims
# ---------------------------------------------------------------------------

def test_shim_solve_cfn_matches_portfolio():
    """solve_cfn() (deprecated) == solve_portfolio under an equivalent
    spec: identical placement, method tag and objective (the template is
    tests/test_api.py::test_shim_solve_cfn_matches_portfolio)."""
    tt = ttopo.paper_topology()
    prob = tp.build_problem(tt, tvsr.random_vsrs(3, rng=5,
                                                 source_nodes=[0]),
                            device="cpu")
    legacy = _quiet(ts.solve_cfn, prob, tt, ts.default_generator(0))
    res = ts.solve_portfolio(prob, tt, TSpec(), ts.default_generator(0))
    np.testing.assert_array_equal(legacy.X, res.X)
    assert legacy.method == res.method
    assert legacy.objective == pytest.approx(res.objective, abs=1e-6)


def test_latency_bounded_embedding_matches_jax():
    """embed_latency_bounded (deprecated): every VM within 2 hops of its
    source, the CDC unreachable, and the result the reference's (quick
    effort on both sides is deterministic; template
    tests/test_core_paper.py::test_latency_bounded_embedding)."""
    jt, tt = jtopo.paper_topology(), ttopo.paper_topology()
    kw = dict(rng=1, source_nodes=[0])
    jv, tv = jvsr.random_vsrs(5, **kw), tvsr.random_vsrs(5, **kw)
    res = _quiet(tembed.embed_latency_bounded, tt, tv, max_hops=2,
                 method="coordinate", device="cpu")
    want = _quiet(jembed.embed_latency_bounded, jt, jv, max_hops=2,
                  method="coordinate")
    hops = tt.path_hops
    for r in range(res.X.shape[0]):
        assert (hops[int(tv.src[r]), res.X[r]] <= 2).all()
    assert tt.proc_index("cdc0") not in set(res.X.reshape(-1))
    assert res.method == want.method == "latency<=2(coordinate)"
    assert res.objective == pytest.approx(want.objective, rel=1e-5)


def test_latency_repair_matches_bruteforce():
    """The delta-sweep repair of the shim returns the placement of the
    brute-force repair (full objective per candidate node), as in
    tests/test_core_paper.py::test_latency_repair_matches_bruteforce."""
    tt = ttopo.paper_topology()
    vs = tvsr.random_vsrs(3, rng=5, source_nodes=[0])
    max_hops = 2
    res = _quiet(tembed.embed_latency_bounded, tt, vs, max_hops=max_hops,
                 device="cpu")
    problem = tp.build_problem(tt, vs, device="cpu")
    base = tembed.embed(tt, vs, TSpec(), problem=problem)
    hops = tt.path_hops
    X = base.X.copy()
    for r in range(X.shape[0]):
        src = int(vs.src[r])
        for v in range(X.shape[1]):
            if hops[src, X[r, v]] > max_hops:
                best, best_obj = X[r, v], float("inf")
                for p in range(tt.P):
                    if hops[src, p] > max_hops:
                        continue
                    X2 = X.copy()
                    X2[r, v] = p
                    o = float(tp.objective(problem, X2))
                    if o < best_obj:
                        best, best_obj = p, o
                X[r, v] = best
    np.testing.assert_array_equal(res.X, X)
