"""The Hopper designs of the two placement kernels: the launch-shape rules
(pure functions, CPU), the plain fused anneal -- whose sums follow the
warp-per-chain kernel's order -- against the JAX package's Pallas kernel
(interpret mode) and the float64 move oracle, and, on a Hopper card only,
each kernel against its plain version at the shapes that exercise each of
its launch configurations.

Tolerances: the plain anneal against the Pallas kernel as in
tests/test_torch_kernels.py (best over chains within 5e-2); a single move
against the float64 oracle within 2e-2 + 1e-6 |objective| (float32 loads);
on the card the kernel's chains must equal its plain version's (the same
arithmetic in the same order accepts the same moves) and its objectives
match within rtol 1e-5 / atol 5e-2; placement_power rtol 2e-5 / atol 1e-2
(float32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import power as tp, solvers as tsolvers, \
    topology as ttopo, vsr as tvsr
from repro_torch.kernels import ops as tops, placement_power as tpp, \
    ref as tref
from test_torch_kernels import _city_on, _pair, _streams, hopper  # noqa: F401


# ---------------------------------------------------------------------------
# Launch shapes (pure functions)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,cs", [(1, 8), (32, 8), (33, 8), (34, 4),
                                  (66, 4), (67, 2), (132, 2), (133, 1),
                                  (300, 1), (1000, 1), (4096, 1)])
def test_placement_power_cluster_size(B, cs):
    """Small batches spread a candidate over a cluster (>= 4 CTAs at the
    main path's B = 32, so B * cs covers the 132 SMs); from B = 133 on one
    CTA a candidate."""
    assert tpp.placement_power_cluster_size(B) == cs
    assert B * cs <= 2 * tpp.N_SMS or cs == 1


def test_fused_anneal_chains_per_block():
    # city_p468, R = 1024 chains of 3 VMs: one chain a block up to 132
    J, P, N, D, K = 3072, 468, 126, 2, 14
    cpb = lambda C, J=J: tpp.fused_anneal_variant(C, J, P, N, D, K)
    assert cpb(32) == ("shared", 1)
    assert cpb(132) == ("shared", 1)
    assert cpb(133) == ("shared", 2)
    # capped by the shared memory a block holds (~30 KB a chain here)
    many = cpb(4096)[1]
    assert many == 7
    assert tpp.fused_anneal_smem_bytes(J, P, N, D, many) <= tpp.SMEM_PER_BLOCK
    assert (tpp.fused_anneal_smem_bytes(J, P, N, D, many + 1)
            > tpp.SMEM_PER_BLOCK)
    # a chain too large for the shared memory takes the global variant
    assert cpb(1, J=40000)[0] == "global"


@pytest.mark.parametrize("J,variant", [(3072, "shared"), (26267, "shared"),
                                       (26268, "global"), (27000, "global"),
                                       (200000, "global")])
def test_fused_anneal_variant_at_city_scale(J, variant):
    """city_p468 chains of 3 VMs (P = 468, N = 126, D = 2, K = 14): one
    chain's X and best X fit a block's shared memory up to J = 26267 VMs
    (8755 VSRs), and past it they live in global memory."""
    P, N, D, K = 468, 126, 2, 14
    got, cpb = tpp.fused_anneal_variant(32, J, P, N, D, K)
    assert (got, cpb) == (variant, 1)
    gx = variant == "global"
    assert tpp.fused_anneal_smem_bytes(J, P, N, D, 1, gx) \
        <= tpp.SMEM_PER_BLOCK
    assert (tpp.fused_anneal_smem_bytes(J, P, N, D, 1)
            > tpp.SMEM_PER_BLOCK) == gx
    # past 132 chains a block holds two, where two fit (not at the cap)
    two = tpp.fused_anneal_smem_bytes(J, P, N, D, 2, gx) \
        <= tpp.SMEM_PER_BLOCK
    assert two == (J != 26267)
    assert tpp.fused_anneal_variant(141, J, P, N, D, K)[1] == 1 + two
    many = tpp.fused_anneal_variant(4096, J, P, N, D, K)[1]
    assert tpp.fused_anneal_smem_bytes(J, P, N, D, many, gx) \
        <= tpp.SMEM_PER_BLOCK
    assert many == 32 or tpp.fused_anneal_smem_bytes(
        J, P, N, D, many + 1, gx) > tpp.SMEM_PER_BLOCK


def test_fused_anneal_variant_delta_where_no_kernel_applies():
    """``("delta", 0)`` for D > 32 (a star VSR of 34 VMs has D = 33) or
    2 * D * K > 1024, and for per-node tables over the shared memory;
    ValueError only for a negative size."""
    prob = tp.build_problem(ttopo.paper_topology(), tvsr.random_vsrs(
        2, rng=0, n_vms=34, source_nodes=[0], topology="star"),
        device="cpu")
    D = int(tp.build_aux(prob).inc_h.shape[1])
    assert D == 33
    assert tpp.fused_anneal_variant(32, prob.R * prob.V, prob.P, prob.N,
                                    D, prob.K) == ("delta", 0)
    assert tpp.fused_anneal_variant(32, 100, 468, 126, 32, 16)[0] == \
        "shared"                                      # 2 D K = 1024
    assert tpp.fused_anneal_variant(32, 100, 468, 126, 32, 17) == \
        ("delta", 0)                                  # 2 D K = 1088
    assert tpp.fused_anneal_variant(1, 10, 8000, 126, 2, 14) == \
        ("delta", 0)                                  # 8 P floats > cap
    with pytest.raises(ValueError, match="negative"):
        tpp.fused_anneal_variant(-1, 10, 468, 126, 2, 14)


def test_anneal_auto_off_the_card_is_delta():
    """Off the card ``"auto"`` is the delta backend whatever the shape; an
    explicit ``"fused"`` runs the kernel's plain version on the CPU."""
    topo = ttopo.paper_topology()
    prob = tp.build_problem(topo, tvsr.random_vsrs(
        2, rng=0, n_vms=34, source_nodes=[0], topology="star"),
        device="cpu")
    X0 = tsolvers.fixed_layer(prob, topo, "iot").X
    res = tsolvers.anneal(prob, tsolvers.default_generator(0), X0,
                          n_chains=4, n_steps=20)
    assert res.method == "anneal"
    fused = tsolvers.anneal(prob, tsolvers.default_generator(0), X0,
                            n_chains=4, n_steps=20, backend="fused")
    assert fused.method == "anneal(fused)"


@pytest.mark.parametrize("M", [1, 28, 56, 70, 140])
def test_warp_sum_is_the_butterfly(M):
    """``_warp_sum`` adds each lane's slots in turn, then pairs lanes at
    offsets 16, 8, 4, 2, 1 -- checked against the same tree in float32
    numpy."""
    v = np.random.default_rng(M).normal(size=(3, M)).astype(np.float32)
    got = tpp._warp_sum(torch.as_tensor(v)).numpy()
    pad = np.zeros((3, -(-M // 32) * 32), np.float32)
    pad[:, :M] = v
    lanes = np.zeros((3, 32), np.float32)
    for i in range(pad.shape[1] // 32):
        lanes = lanes + pad[:, 32 * i:32 * (i + 1)]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    np.testing.assert_array_equal(got, lanes[:, 0])
    np.testing.assert_allclose(got, v.astype(np.float64).sum(1), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The plain fused anneal (the kernel's order) against the references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,T,n_vsrs,seed,key", [(6, 250, 5, 1, 7),
                                                 (5, 60, 3, 2, 11)])
def test_fused_anneal_masked_plain_vs_pallas_streams(C, T, n_vsrs, seed,
                                                     key):
    """With an eligibility mask, on the reference's proposal streams, at
    the two chain counts of the unmasked test."""
    jprob, tprob = _pair(n_vsrs)
    jaux, Xc, j, p, u, temps = _streams(jprob, C, T, seed, key)
    el = np.random.default_rng(seed + 10).random((tprob.R, tprob.P)) < 0.4
    el[:, 0] = True
    bX, stats = tops.fused_anneal(tprob, tp.build_aux(tprob), Xc, j, p, u,
                                  temps, eligible=el)
    exact = tp.objective_batch(tprob, bX).numpy()
    np.testing.assert_allclose(stats[:, 0].numpy(), exact, rtol=1e-5,
                               atol=5e-2)
    _, jstats = jops.fused_anneal(jprob, jaux, jnp.asarray(Xc),
                                  jnp.asarray(j), jnp.asarray(p),
                                  jnp.asarray(u), jnp.asarray(temps),
                                  eligible=jnp.asarray(el))
    assert abs(float(stats[:, 0].min())
               - float(np.asarray(jstats[:, 0]).min())) <= 5e-2


def test_fused_anneal_star_plain_vs_pallas():
    """Star VSRs of 6 VMs: the hub has D = 5 links, M = 2 * D * K = 70
    route slots at paper scale -- three slots on some lanes."""
    jprob, tprob = _pair(3, seed=5, n_vms=6, vtopo="star")
    assert tp.build_aux(tprob).inc_h.shape[1] == 5
    C, T = 4, 60
    jaux, Xc, j, p, u, temps = _streams(jprob, C, T, 5, 13)
    bX, stats = tops.fused_anneal(tprob, tp.build_aux(tprob), Xc, j, p, u,
                                  temps)
    exact = tp.objective_batch(tprob, bX).numpy()
    np.testing.assert_allclose(stats[:, 0].numpy(), exact, rtol=1e-5,
                               atol=5e-2)
    _, jstats = jops.fused_anneal(jprob, jaux, jnp.asarray(Xc),
                                  jnp.asarray(j), jnp.asarray(p),
                                  jnp.asarray(u), jnp.asarray(temps))
    assert abs(float(stats[:, 0].min())
               - float(np.asarray(jstats[:, 0]).min())) <= 5e-2


def test_fused_anneal_cancelling_routes_vs_delta_ref():
    """Moves whose removal and insertion routes share node ids, where the
    same link's -h and +h meet and cancel: one accepted step of the plain
    fused anneal moves the objective by the float64 oracle's delta."""
    _, tprob = _pair(6, seed=3)
    aux = tp.build_aux(tprob)
    P, N, V = tprob.P, tprob.N, tprob.V
    rng = np.random.default_rng(3)
    X = tp.apply_pins(tprob, rng.integers(0, P, (tprob.R, V))).numpy()
    route = tprob.route_idx.numpy()
    inc_o, inc_h = aux.inc_other.numpy(), aux.inc_h.numpy()
    inc_s = aux.inc_src.numpy()
    moves = []
    for j in aux.free_flat.numpy():
        po = X.reshape(-1)[j]
        for pn in range(P):
            if pn == po:
                continue
            for d in range(inc_h.shape[1]):
                if inc_h[j, d] == 0 or inc_o[j, d] == j:
                    continue
                q = X.reshape(-1)[inc_o[j, d]]
                row = (lambda a: route[a, q] if inc_s[j, d] else route[q, a])
                rm, ins = set(row(po)) - {N}, set(row(pn)) - {N}
                if rm & ins:
                    moves.append((int(j), pn))
                    break
    assert len(moves) >= 8
    moves = [moves[i] for i in rng.choice(len(moves), 8, replace=False)]
    C = len(moves)
    Xc = np.broadcast_to(X, (C,) + X.shape).copy()
    j = np.array([[m[0]] for m in moves], np.int32)
    p = np.array([[m[1]] for m in moves], np.int32)
    u = np.zeros((C, 1), np.float32)          # accept every move
    _, _, _, obj0 = tp.batched_hard_loads(tprob, torch.as_tensor(Xc))
    _, stats = tops.fused_anneal(tprob, aux, Xc, j, p, u,
                                 np.array([1e9], np.float32))
    for c, (jj, pn) in enumerate(moves):
        want = tref.placement_delta_ref(tprob, X, jj // V, jj % V, pn)
        got = float(stats[c, 1]) - float(obj0[c])
        assert abs(got - want) <= 2e-2 + 1e-6 * abs(float(obj0[c])), \
            (jj, pn, got, want)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _fused_args(topo, prob, C, T, seed):
    dev = prob.device
    aux = tp.build_aux(prob)
    rng = np.random.default_rng(seed)
    Xc = tp.apply_pins(prob, np.broadcast_to(
        tsolvers.fixed_layer(prob, topo, "iot").X, (C, prob.R, prob.V)))
    fi = torch.as_tensor(rng.integers(0, aux.free_flat.shape[0], (C, T)),
                         device=dev)
    j = aux.free_flat[fi].to(torch.int32).contiguous()
    p = torch.as_tensor(rng.integers(0, prob.P, (C, T), dtype=np.int32),
                        device=dev)
    u = torch.as_tensor(rng.random((C, T), dtype=np.float32), device=dev)
    temps = torch.as_tensor((5.0 * (0.05 / 5.0) ** (
        np.arange(T) / max(1, T - 1))).astype(np.float32), device=dev)
    loads = [t.contiguous() for t in tp.batched_hard_loads(prob, Xc)]
    _, _, F, _, route, pp_, nn_ = tpp.pack_problem(prob)
    return (Xc.reshape(C, -1).contiguous(), j, p, u, temps,
            *tpp.pack_aux(aux), *loads, F, route, pp_, nn_)


def _held(prob, args, key="fused_anneal"):
    C = args[0].shape[0]
    n = tpp.LAUNCHES[key]
    bk, sk = tpp.fused_anneal_cuda(*args)
    torch.cuda.synchronize()
    assert tpp.LAUNCHES[key] == n + 1
    br, sr = tpp.fused_anneal_ref(*args)
    assert int((bk == br).all(1).sum()) == C
    torch.testing.assert_close(sk, sr, rtol=1e-5, atol=5e-2)
    exact = tp.objective_batch(prob, bk.reshape(C, prob.R, prob.V))
    torch.testing.assert_close(sk[:, 0], exact, rtol=1e-5, atol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 5, 33, 141])
@pytest.mark.parametrize("T", [1, 300])
def test_fused_anneal_warp_kernel_vs_plain(hopper, C, T):
    """One chain a block up to C = 132; C = 141 runs two a block, the last
    block with one; T = 1 runs the prologue and one step."""
    topo, prob = _city_on(hopper)
    _held(prob, _fused_args(topo, prob, C, T, seed=C + T))


@pytest.mark.gpu
def test_fused_anneal_warp_kernel_star(hopper):
    """Star VSRs of 6 VMs at city scale: D = 5, M = 140 > 64 route slots
    (the kernel's 8-slots-a-lane build)."""
    topo, prob = _city_on(hopper, n_vsrs=128, n_vms=6, vtopo="star")
    args = _fused_args(topo, prob, 8, 300, seed=3)
    D, K = args[6].shape[1], args[13].shape[1]
    assert 2 * D * K > 64
    _held(prob, args)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [5, 33])
def test_fused_anneal_global_kernel_vs_plain(hopper, C):
    """9000 VSRs of 3 VMs at city_p468: J = 27000 VMs, past the shared
    memory's cap, so the chains' X and best X live in global memory; every
    chain equal to the plain version's."""
    topo, prob = _city_on(hopper, n_vsrs=9000)
    args = _fused_args(topo, prob, C, 300, seed=C)
    J, D, K = args[0].shape[1], args[6].shape[1], args[13].shape[1]
    assert tpp.fused_anneal_variant(C, J, prob.P, prob.N, D, K)[0] == \
        "global"
    _held(prob, args, key="fused_anneal_global")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 32, 33, 300, 4096])
def test_placement_power_cluster_kernel_vs_plain(hopper, B):
    _, prob = _city_on(hopper)
    rng = np.random.default_rng(B)
    Xb = torch.as_tensor(rng.integers(0, prob.P, (B, prob.R, prob.V),
                                      dtype=np.int32), device=hopper)
    Xf = tp.apply_pins(prob, Xb).reshape(B, -1).contiguous()
    operands = tpp.pack_problem(prob)
    assert (tpp.placement_power_cluster_size(B) > 1) == (B <= 132)
    n = tpp.LAUNCHES["placement_power"]
    got = tpp.placement_power_cuda(Xf, *operands)
    torch.cuda.synchronize()
    assert tpp.LAUNCHES["placement_power"] == n + 1
    torch.testing.assert_close(got, tpp.placement_power_ref(Xf, *operands),
                               rtol=2e-5, atol=1e-2)
    f64 = [tref.placement_objective_f64(prob, Xb[i]) for i in range(min(B, 4))]
    np.testing.assert_allclose(got[:len(f64), 0].cpu().numpy(), f64,
                               rtol=2e-5, atol=1e-2)
