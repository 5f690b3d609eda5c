"""Placement kernels of the PyTorch port: the plain PyTorch versions against
the JAX package's Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py and tests/test_delta.py run them), and -- on a Hopper
card only -- each CUDA kernel against its plain version.

Tolerances: full evaluation rtol 2e-5 / atol 1e-2 (float32 sums in another
order); annealing: a chain's reported best equals the exact objective of
its best placement within rtol 1e-5 / atol 5e-2 (float32 drift of the
carried objective), and the best over chains matches the reference's on the
same proposal streams within 5e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import power as jp, solvers as js, topology as jtopo, \
    vsr as jvsr
from repro.kernels import ops as jops, placement_power as jpp
from repro_torch.core import power as tp, topology as ttopo, vsr as tvsr
from repro_torch.kernels import flash_attention as tfa, ops as tops, \
    placement_power as tpp, ref as tref


def _pair(n_vsrs, seed=0, n_vms=3, topo="paper"):
    if topo == "paper":
        jt, tt = jtopo.paper_topology(), ttopo.paper_topology()
    else:
        kw = dict(n_olt=2, onus_per_olt=4, iot_per_onu=8)
        jt, tt = jtopo.city_scale(**kw), ttopo.city_scale(**kw)
    kw = dict(rng=seed, n_vms=n_vms, source_nodes=[0, 1])
    return (jp.build_problem(jt, jvsr.random_vsrs(n_vsrs, **kw)),
            tp.build_problem(tt, tvsr.random_vsrs(n_vsrs, **kw),
                             device="cpu"))


@pytest.mark.parametrize("B,seed,n_vsrs,n_vms,topo", [
    (5, 0, 3, 3, "paper"), (17, 1, 6, 4, "paper"), (17, 2, 4, 2, "city")])
def test_placement_objective_plain_vs_pallas(B, seed, n_vsrs, n_vms, topo):
    jprob, tprob = _pair(n_vsrs, seed, n_vms, topo)
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, tprob.P, (B, tprob.R, tprob.V)).astype(np.int32)
    want = np.asarray(jops.placement_objective(jprob, jnp.asarray(Xb)))
    got = tops.placement_objective(tprob, Xb)
    assert got.shape == (B, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-2)
    np.testing.assert_allclose(
        got.numpy(), tref.placement_objective_ref(tprob, Xb).numpy(),
        rtol=2e-5, atol=1e-2)
    f64 = [tref.placement_objective_f64(tprob, X) for X in Xb]
    np.testing.assert_allclose(got[:, 0].numpy(), f64, rtol=2e-5, atol=1e-2)


def _streams(jprob, C, T, seed, key):
    """Chain starts and the reference's own proposal streams (numpy)."""
    jaux = jp.build_aux(jprob)
    rng = np.random.default_rng(seed)
    X0 = rng.integers(0, jprob.P, (C, jprob.R, jprob.V)).astype(np.int32)
    Xc = np.asarray(jax.vmap(lambda x: jp.apply_pins(jprob, x))(
        jnp.asarray(X0)))
    fi, p, u = js._anneal_proposals(jax.random.PRNGKey(key), jaux, T, C,
                                    jprob.P)
    j = np.asarray(jaux.free_flat[fi])
    temps = (50.0 * (0.05 / 50.0) ** (np.arange(T) / max(1, T - 1))
             ).astype(np.float32)
    return jaux, Xc, j.T.copy(), np.asarray(p).T.copy(), \
        np.asarray(u).T.copy(), temps


@pytest.mark.parametrize("C,T,n_vsrs,seed,key", [(6, 250, 5, 1, 7),
                                                 (5, 60, 3, 2, 11)])
def test_fused_anneal_plain_vs_pallas(C, T, n_vsrs, seed, key):
    """The plain fused anneal on the reference's proposal streams (paper
    scale; C=5 is an odd chain count the TPU wrapper had to pad)."""
    jprob, tprob = _pair(n_vsrs)
    jaux, Xc, j, p, u, temps = _streams(jprob, C, T, seed, key)
    taux = tp.build_aux(tprob)
    bX, stats = tops.fused_anneal(tprob, taux, Xc, j, p, u, temps)
    assert bX.shape == (C, tprob.R, tprob.V) and stats.shape == (C, 2)
    exact = tp.objective_batch(tprob, bX).numpy()
    np.testing.assert_allclose(stats[:, 0].numpy(), exact, rtol=1e-5,
                               atol=5e-2)
    _, jstats = jops.fused_anneal(jprob, jaux, jnp.asarray(Xc),
                                  jnp.asarray(j), jnp.asarray(p),
                                  jnp.asarray(u), jnp.asarray(temps))
    assert abs(float(stats[:, 0].min())
               - float(np.asarray(jstats[:, 0]).min())) <= 5e-2


def test_fused_anneal_masked_plain_vs_pallas():
    """With an eligibility mask the proposals are projected the same way
    (``mask_proposals``) and the chains stay on eligible nodes."""
    jprob, tprob = _pair(4, seed=3)
    C, T = 4, 80
    jaux, Xc, j, p, u, temps = _streams(jprob, C, T, 3, 5)
    el = np.random.default_rng(4).random((tprob.R, tprob.P)) < 0.4
    el[:, 0] = True
    taux = tp.build_aux(tprob)
    bX, stats = tops.fused_anneal(tprob, taux, Xc, j, p, u, temps,
                                  eligible=el)
    _, jstats = jops.fused_anneal(jprob, jaux, jnp.asarray(Xc),
                                  jnp.asarray(j), jnp.asarray(p),
                                  jnp.asarray(u), jnp.asarray(temps),
                                  eligible=jnp.asarray(el))
    assert abs(float(stats[:, 0].min())
               - float(np.asarray(jstats[:, 0]).min())) <= 5e-2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_proposals_matches_reference(seed):
    rng = np.random.default_rng(seed)
    R, P, V, C, T = 6, 11, 3, 4, 30
    el = rng.random((R, P)) < 0.3
    el[2] = False                       # an empty row falls back to node 0
    j = rng.integers(0, R * V, (C, T)).astype(np.int32)
    p = rng.integers(0, P, (C, T)).astype(np.int32)
    want = np.asarray(jpp.mask_proposals(jnp.asarray(j), jnp.asarray(p),
                                         jnp.asarray(el), V))
    got = tpp.mask_proposals(torch.as_tensor(j), torch.as_tensor(p),
                             torch.as_tensor(el), V)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_problem_layout():
    _, tprob = _pair(3)
    ls, ld, F, H, route, pp_, nn_ = tpp.pack_problem(tprob)
    assert route.dtype == torch.int32
    assert route.shape == (tprob.P * tprob.P, tprob.K)
    assert torch.equal(route.reshape(tprob.route_idx.shape),
                       tprob.route_idx)
    assert pp_.shape == (9, tprob.P) and nn_.shape == (5, tprob.N)
    assert torch.equal(pp_[6], tprob.C_lan) and torch.equal(nn_[4],
                                                            tprob.idle_share)
    assert all(t.is_contiguous() for t in (ls, ld, F, H, route, pp_, nn_))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The launch wrappers take CUDA tensors only: they raise rather than
    run anything else."""
    _, tprob = _pair(3)
    X = tp.apply_pins(tprob, np.zeros((2, tprob.R, tprob.V), np.int32))
    before = dict(tpp.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tpp.placement_power_cuda(X.reshape(2, -1).contiguous(),
                                 *tpp.pack_problem(tprob))
    assert tpp.LAUNCHES == before
    q = torch.zeros(1, 3, 4, 16)
    pos = torch.arange(3, dtype=torch.int32)
    before = dict(tfa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q, pos, pos)
    assert tfa.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _city_on(device, n_vsrs=256):
    topo = ttopo.city_scale(n_olt=16, onus_per_olt=4, iot_per_onu=7)
    vs = tvsr.random_vsrs(n_vsrs, rng=0, source_nodes=range(64))
    return topo, tp.build_problem(topo, vs, device=device)


@pytest.mark.gpu
def test_placement_power_kernel_vs_plain(hopper):
    _, prob = _city_on(hopper)
    rng = np.random.default_rng(0)
    Xb = torch.as_tensor(rng.integers(0, prob.P, (300, prob.R, prob.V),
                                      dtype=np.int32), device=hopper)
    Xf = tp.apply_pins(prob, Xb).reshape(300, -1).contiguous()
    operands = tpp.pack_problem(prob)
    n = tpp.LAUNCHES["placement_power"]
    got = tpp.placement_power_cuda(Xf, *operands)
    torch.cuda.synchronize()
    assert tpp.LAUNCHES["placement_power"] == n + 1
    torch.testing.assert_close(got, tpp.placement_power_ref(Xf, *operands),
                               rtol=2e-5, atol=1e-2)


@pytest.mark.gpu
def test_fused_anneal_kernel_vs_plain(hopper):
    from repro_torch.core import solvers
    topo, prob = _city_on(hopper)
    aux = tp.build_aux(prob)
    C, T = 8, 300
    rng = np.random.default_rng(1)
    Xc = tp.apply_pins(prob, np.broadcast_to(
        solvers.fixed_layer(prob, topo, "iot").X, (C, prob.R, prob.V)))
    fi = torch.as_tensor(rng.integers(0, aux.free_flat.shape[0], (C, T)),
                         device=hopper)
    j = aux.free_flat[fi].to(torch.int32).contiguous()
    p = torch.as_tensor(rng.integers(0, prob.P, (C, T), dtype=np.int32),
                        device=hopper)
    u = torch.as_tensor(rng.random((C, T), dtype=np.float32), device=hopper)
    temps = torch.as_tensor((5.0 * (0.05 / 5.0) ** (np.arange(T) / (T - 1))
                             ).astype(np.float32), device=hopper)
    loads = [t.contiguous() for t in tp.batched_hard_loads(prob, Xc)]
    _, _, F, _, route, pp_, nn_ = tpp.pack_problem(prob)
    args = (Xc.reshape(C, -1).contiguous(), j, p, u, temps,
            *tpp.pack_aux(aux), *loads, F, route, pp_, nn_)
    bk, sk = tpp.fused_anneal_cuda(*args)
    br, sr = tpp.fused_anneal_ref(*args)
    exact = tp.objective_batch(prob, bk.reshape(C, prob.R, prob.V))
    torch.testing.assert_close(sk[:, 0], exact, rtol=1e-5, atol=5e-2)
    assert abs(float(sk[:, 0].min()) - float(sr[:, 0].min())) <= 5e-2
