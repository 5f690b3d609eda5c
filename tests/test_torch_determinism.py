"""Order-fixed load sums (``core/power.py::fixed_order``).

On CUDA, ``scatter_add_`` / ``index_add_`` add with atomics in no fixed
order, so the float32 loads of one placement could differ in their last
bit from call to call; the port sums them under torch's deterministic
algorithms there.  On the CPU the sums are sequential and nothing changes:
the context is a no-op and the sums equal numpy's.  On the card (``gpu``
marker) repeated load builds and two solves from one generator seed must be
bit-equal."""
import numpy as np
import pytest
import torch

from repro_torch.api import CFNSession, PlacementSpec
from repro_torch.core import power as tp, topology as ttopo, vsr as tvsr
from test_torch_kernels import hopper  # noqa: F401

CITY = dict(n_olt=16, onus_per_olt=4, iot_per_onu=7)


def test_fixed_order_is_a_noop_on_the_cpu():
    x = torch.zeros(4)
    with tp.fixed_order(x):
        assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 7, size=(3, 50))
    val = rng.random((3, 50)).astype(np.float32)
    got = tp._scatter_rows(7, torch.as_tensor(idx), torch.as_tensor(val))
    want = np.stack([np.bincount(i, v, minlength=7) for i, v in zip(idx,
                                                                    val)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_cuda_sum_routes_equal_the_scatter_on_the_cpu():
    """The CUDA routes' arithmetic, run on the CPU: the one-hot reduction
    of ``_onehot_rows`` (also batched and under ``vmap``) and the
    ``route_counts`` product of ``_lam_from_tm`` equal the sequential
    scatter (float32 sums in another order: rtol 1e-5)."""
    rng = np.random.default_rng(1)
    idx = torch.as_tensor(rng.integers(0, 9, size=(4, 3, 56)))
    val = torch.as_tensor(rng.standard_normal((4, 3, 56)),
                          dtype=torch.float32)
    want = tp._scatter_rows(9, idx, val)
    torch.testing.assert_close(tp._onehot_rows(9, idx, val), want,
                               rtol=1e-5, atol=1e-5)
    got = torch.func.vmap(lambda i, v: tp._onehot_rows(9, i, v))(idx, val)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    topo = ttopo.city_scale(n_olt=2, onus_per_olt=4, iot_per_onu=8)
    prob = tp.build_problem(topo, tvsr.random_vsrs(8, rng=2, n_vms=3),
                            device="cpu")
    tm = torch.as_tensor(rng.random((2, prob.P, prob.P)),
                         dtype=torch.float32)
    via_counts = (tm.reshape(2, -1) @ prob.route_counts)[:, :prob.N]
    torch.testing.assert_close(via_counts, tp._lam_from_tm(prob, tm),
                               rtol=1e-5, atol=1e-3)
    assert prob.route_counts.sum() == prob.P * prob.P * prob.K


def _bits(st):
    return [getattr(st, k).cpu().numpy().tobytes()
            for k in ("omega", "theta", "lam", "tm", "obj")]


@pytest.mark.gpu
def test_loads_bit_equal_on_the_card(hopper):
    """16 ``init_state`` builds of one 1024-VSR placement at city_p468:
    every load and the objective bit-equal to the first, the flag left
    as it was; two soft ``_lam_from_tm`` sums bit-equal."""
    topo = ttopo.city_scale(**CITY)
    vs = tvsr.random_vsrs(1024, rng=0, n_vms=3, source_nodes=range(64))
    prob = tp.build_problem(topo, vs, device=hopper)
    X = torch.as_tensor(np.random.default_rng(0).integers(
        0, prob.P, (prob.R, prob.V)), dtype=torch.int32, device=hopper)
    first = _bits(tp.init_state(prob, X))
    for _ in range(15):
        assert _bits(tp.init_state(prob, X)) == first
    assert not torch.are_deterministic_algorithms_enabled()
    tm = torch.rand((prob.P, prob.P), generator=torch.Generator(
        ).manual_seed(0)).to(hopper)
    lam = tp._lam_from_tm(prob, tm)
    assert torch.equal(tp._lam_from_tm(prob, tm), lam)


@pytest.mark.gpu
def test_two_solves_bit_equal_on_the_card(hopper):
    """Two sessions from one generator seed solve 64 VSRs at city_p468 to
    the same placement and objective, bit for bit."""
    topo = ttopo.city_scale(**CITY)
    vs = tvsr.random_vsrs(64, rng=0, n_vms=3, source_nodes=range(64))
    out = []
    for _ in range(2):
        sess = CFNSession(topo, PlacementSpec(defrag_every=8), device=hopper)
        res = sess.solve(vs)
        out.append((res.X.tobytes(), res.objective))
    assert out[0] == out[1]
