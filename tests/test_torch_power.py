"""Power model of the PyTorch port against the JAX package: problem tensors,
full evaluation, the delta engine (move deltas against the float64 oracle,
state consistency, the destination sweep) and both lambda branches (the
dense route rows at paper scale, the CSR table above DENSE_ROUTE_MAX_P).

Inputs are numpy arrays from a seed, fed to both packages; the port runs on
the CPU.  Tolerances: full evaluation rtol 2e-5 / atol 1e-2 (float32 sums in
another order); move deltas 1e-3 on feasible and 5e-2 on violated sequences
(tests/test_delta.py's bounds: PENALTY * float32 ulp of the loads)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import power as jp, topology as jtopo, vsr as jvsr
from repro.kernels import ref as jref
from repro_torch.core import power as tp, topology as ttopo, vsr as tvsr
from repro_torch.kernels import ref as tref

CPU = "cpu"
SCALES = {
    "paper": dict(fn="paper_topology", kw={}),
    "city": dict(fn="city_scale",
                 kw=dict(n_olt=2, onus_per_olt=4, iot_per_onu=8)),
}


@pytest.fixture(scope="module", params=sorted(SCALES))
def pair(request):
    """(name, JAX topology, port topology) per scale: paper (P=23, dense
    route rows) and a small city (P=70, CSR branch)."""
    s = SCALES[request.param]
    return (request.param, getattr(jtopo, s["fn"])(**s["kw"]),
            getattr(ttopo, s["fn"])(**s["kw"]))


def _problems(pair, n_vsrs=10, seed=0, **kw):
    _, jt, tt = pair
    sources = [0, 3, 5]
    jv = jvsr.random_vsrs(n_vsrs, rng=seed, source_nodes=sources, **kw)
    tv = tvsr.random_vsrs(n_vsrs, rng=seed, source_nodes=sources, **kw)
    return jp.build_problem(jt, jv), tp.build_problem(tt, tv, device=CPU)


def jax_arrays(jprob) -> dict:
    return {f.name: (None if getattr(jprob, f.name) is None
                     else np.asarray(getattr(jprob, f.name)))
            for f in dataclasses.fields(jprob)}


def _assert_same_problem(a: tp.PlacementProblem, b: tp.PlacementProblem):
    for f in dataclasses.fields(tp.PlacementProblem):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert torch.equal(x, y), f.name


@pytest.mark.parametrize("pad", [(None, None), (16, None), (None, 4),
                                 (16, 4)])
def test_problem_from_numpy_equals_build_problem(pair, pad):
    _, jt, tt = pair
    jv = jvsr.random_vsrs(5, rng=3, source_nodes=[0, 2])
    tv = tvsr.random_vsrs(5, rng=3, source_nodes=[0, 2])
    jprob = jp.build_problem(jt, jv, pad_to_rows=pad[0], pad_to_cols=pad[1])
    tprob = tp.build_problem(tt, tv, pad_to_rows=pad[0], pad_to_cols=pad[1],
                             device=CPU)
    carried = tp.problem_from_numpy(jax_arrays(jprob), device=CPU)
    _assert_same_problem(carried, tprob)
    assert tprob.route_idx.dtype == torch.int32
    assert tprob.link_src.dtype == torch.int32
    assert (tprob.route_dense is not None) == (tprob.P <= 64)


def _placements(prob, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, prob.P, size=(n, prob.R, prob.V)).astype(np.int32)


def test_evaluate_matches_jax(pair):
    jprob, tprob = _problems(pair)
    for X in _placements(tprob, 4, seed=1):
        a = jp.evaluate(jprob, jnp.asarray(X))
        b = tp.evaluate(tprob, X)
        for field in a._fields:
            np.testing.assert_allclose(getattr(b, field).numpy(),
                                       np.asarray(getattr(a, field)),
                                       rtol=2e-5, atol=1e-2, err_msg=field)


def test_objective_batch_matches_jax_and_f64(pair):
    jprob, tprob = _problems(pair)
    Xb = _placements(tprob, 9, seed=2)
    a = np.asarray(jp.objective_batch(jprob, jnp.asarray(Xb)))
    b = tp.objective_batch(tprob, Xb).numpy()
    np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-2)
    for X, got in zip(Xb, b):
        f64 = tref.placement_objective_f64(tprob, X)
        assert f64 == pytest.approx(jref.placement_objective_f64(jprob, X),
                                    rel=1e-12)
        assert got == pytest.approx(f64, rel=2e-5, abs=1e-2)


def test_init_state_matches_jax(pair):
    jprob, tprob = _problems(pair)
    X = _placements(tprob, 1, seed=3)[0]
    a = jp.init_state(jprob, jnp.asarray(X))
    b = tp.init_state(tprob, X)
    np.testing.assert_array_equal(b.X.numpy(), np.asarray(a.X))
    for field in ("omega", "tm", "theta", "lam", "obj"):
        np.testing.assert_allclose(getattr(b, field).numpy(),
                                   np.asarray(getattr(a, field)),
                                   rtol=2e-5, atol=1e-2, err_msg=field)


def test_batched_hard_loads_matches_jax(pair):
    jprob, tprob = _problems(pair)
    Xc = np.asarray(jp.apply_pins(jprob, jnp.asarray(
        _placements(tprob, 5, seed=4))))
    for a, b in zip(jp.batched_hard_loads(jprob, jnp.asarray(Xc)),
                    tp.batched_hard_loads(tprob, Xc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=1e-2)


def test_lam_branches_agree(pair):
    """The dense-row branch and the CSR branch of ``_lam_from_links`` give
    the same lambda as the JAX package's (whichever branch it takes)."""
    jprob, tprob = _problems(pair)
    csr = dataclasses.replace(tprob, route_dense=None)
    dense_rows = torch.as_tensor(
        pair[2].dense_path_nodes().reshape(tprob.P * tprob.P, tprob.N))
    dense = dataclasses.replace(tprob, route_dense=dense_rows)
    Xp = tp.apply_pins(tprob, _placements(tprob, 3, seed=5))
    want = np.stack([np.asarray(jp._lam_from_links(jprob, jnp.asarray(
        x.reshape(-1).numpy()))) for x in Xp])
    for prob in (csr, dense):
        got = tp._lam_from_links(prob, Xp.reshape(3, -1)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


def _moves(taux, prob, rng, n):
    free = taux.free_pos.numpy()
    for _ in range(n):
        r, v = free[rng.integers(0, len(free))]
        yield int(r), int(v), int(rng.integers(0, prob.P))


@pytest.mark.parametrize("feasible", [True, False])
def test_delta_move_vs_f64_oracle(pair, feasible):
    """Every delta along a random 120-move sequence matches the float64
    oracle (1e-3 feasible-leaning, 5e-2 with capacity violations active),
    and the committed state agrees with a fresh build."""
    topo = pair[2]
    if feasible:
        _, tprob = _problems(pair, vm_gflops=(0.5, 2.0))
        from repro_torch.core import solvers
        X = solvers.fixed_layer(tprob, topo, "iot").X
        tol = 1e-3
    else:
        _, tprob = _problems(pair)
        X = _placements(tprob, 1, seed=6)[0]
        tol = 5e-2
    aux = tp.build_aux(tprob)
    st = tp.init_state(tprob, X)
    rng = np.random.default_rng(7)
    for r, v, p_new in _moves(aux, tprob, rng, 120):
        got = float(tp.delta_move(tprob, aux, st, r, v, p_new))
        want = tref.placement_delta_ref(tprob, st.X, r, v, p_new)
        assert abs(got - want) <= tol, (r, v, p_new, got, want)
        st = tp.apply_move(tprob, aux, st, r, v, p_new)
    fresh = tp.init_state(tprob, st.X)
    for field in ("omega", "tm", "theta", "lam"):
        np.testing.assert_allclose(getattr(st, field).numpy(),
                                   getattr(fresh, field).numpy(),
                                   rtol=1e-5, atol=1e-2, err_msg=field)
    assert float(st.obj) == pytest.approx(float(fresh.obj), rel=1e-5,
                                          abs=5e-2)


def test_delta_move_matches_jax(pair):
    jprob, tprob = _problems(pair)
    jaux, taux = jp.build_aux(jprob), tp.build_aux(tprob)
    X = _placements(tprob, 1, seed=8)[0]
    jst, tst = jp.init_state(jprob, jnp.asarray(X)), tp.init_state(tprob, X)
    rng = np.random.default_rng(9)
    for r, v, p_new in _moves(taux, tprob, rng, 30):
        a = float(jp.delta_move(jprob, jaux, jst, r, v, p_new))
        b = float(tp.delta_move(tprob, taux, tst, r, v, p_new))
        assert b == pytest.approx(a, rel=2e-5, abs=1e-2)


def test_delta_sweep_matches_jax(pair):
    """The all-destination sweep agrees with JAX's, entry ``p_old`` equals
    the current objective, and every entry equals obj + delta_move."""
    jprob, tprob = _problems(pair, n_vsrs=6, n_vms=4, topology="dag")
    jaux, taux = jp.build_aux(jprob), tp.build_aux(tprob)
    X = _placements(tprob, 1, seed=10)[0]
    jst, tst = jp.init_state(jprob, jnp.asarray(X)), tp.init_state(tprob, X)
    for r, v in taux.free_pos.numpy()[::3].tolist():
        a = np.asarray(jp.delta_sweep(jprob, jaux, jst, r, v))
        b = tp.delta_sweep(tprob, taux, tst, r, v).numpy()
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-2)
        p_old = int(tst.X[r, v])
        assert b[p_old] == pytest.approx(float(tst.obj), rel=2e-5, abs=5e-2)
        for p_new in (0, tprob.P // 2, tprob.P - 1):
            d = float(tp.delta_move(tprob, taux, tst, r, v, p_new))
            assert b[p_new] == pytest.approx(float(tst.obj) + d, rel=2e-5,
                                             abs=5e-2)


def test_apply_move_leaves_input_state_unchanged(pair):
    _, tprob = _problems(pair)
    aux = tp.build_aux(tprob)
    st = tp.init_state(tprob, _placements(tprob, 1, seed=11)[0])
    before = [t.clone() for t in st]
    r, v = aux.free_pos[0].tolist()
    tp.apply_move(tprob, aux, st, r, v, (int(st.X[r, v]) + 1) % tprob.P)
    for a, b in zip(before, st):
        assert torch.equal(a, b)


def test_summarize_matches_jax(pair):
    jprob, tprob = _problems(pair)
    X = _placements(tprob, 1, seed=12)[0]
    a = jp.summarize(jprob, pair[1], X)
    b = tp.summarize(tprob, pair[2], X)
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k] == pytest.approx(a[k], rel=2e-5, abs=1e-2), k


def test_soft_evaluate_not_ported():
    """The soft surrogate (``hard=False``), once unported, now equals the
    JAX package's on a uniform assignment (rtol 1e-5; the gradient is
    held in tests/test_torch_relax.py)."""
    jt, tt = jtopo.paper_topology(), ttopo.paper_topology()
    jprob = jp.build_problem(jt, jvsr.random_vsrs(2))
    prob = tp.build_problem(tt, tvsr.random_vsrs(2), device=CPU)
    soft = np.full((prob.R, prob.V, prob.P), 1.0 / prob.P, np.float32)
    for temp in (1.0, 0.05):
        want = jp.evaluate(jprob, jnp.asarray(soft), hard=False, temp=temp)
        got = tp.evaluate(prob, soft, hard=False, temp=temp)
        for name in ("total", "violation", "per_net", "per_proc"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6)
