"""Top-k MoE of the PyTorch port against the JAX package's ``layers.moe``:
each dispatch path (``onehot``, ``sort``, ``ep_sort``; the last takes the
expert-parallel path from 4096 tokens) on the olmoe-1b-7b and
deepseek-v2-236b smoke configurations (deepseek with its shared expert),
the JAX weights carried across, in float32.

Cases: at the default capacity factor 1.25 with a router skewed towards
expert 0, so that its queue overflows -- the output and the dropped
(token, k) set equal the reference's; at 8.0, where nothing drops, the
three paths agree (``tests/test_models.py``'s lossless case); a router
with duplicated columns, so that the top k tie -- the chosen experts equal
``lax.top_k``'s; in bfloat16, token by token; the capacity formulas at
the serving shapes.

Tolerance: atol 1e-5 (the reference's own between its paths; the same
float32 arithmetic summed in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL, model as JM
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL

ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b")
IMPLS = ("onehot", "sort", "ep_sort")
# [B, S]: 128 tokens (``ep_sort`` takes ``sort``; ``onehot`` cuts 2 groups)
# and 4096 (``ep_sort`` takes the expert-parallel path; ``onehot`` 64 groups)
SHAPES = {"small": (2, 64), "ep": (2, 2048)}
j_moe = jax.jit(JL.moe, static_argnums=(2, 3))


def _cfgs(arch: str, **kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32",
                               **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32",
                               **kw)
    return jcfg, tcfg


def _moe_block(arch: str, cfg):
    """The first MoE block's parameters (numpy) of the reference's init:
    olmoe's layer 0, deepseek's first ``mla_moe`` layer."""
    params, _ = JM.init_model(cfg, jax.random.PRNGKey(0))
    gi = len(JM.layer_plan(cfg)) - 1
    return {k: np.asarray(v[0]) for k, v in params[f"g{gi}"]["b0"].items()}


def _both(block):
    return ({k: jnp.asarray(v) for k, v in block.items()},
            {k: torch.from_numpy(v.copy()) for k, v in block.items()})


def _ref_dropped(router, x, cfg, impl: str) -> np.ndarray:
    """[B, S, K] bool: the (token, k) pairs the reference drops -- its
    routing (``lax.top_k`` of the softmax), queue positions by the
    cumulative one-hot count in (token, k) order, and its capacity for
    each path, group by group as ``moe`` cuts them."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    chunk = S
    if impl == "onehot":
        chunk = max(1, min(S, cfg.moe_group_tokens // B))
        while S % chunk:
            chunk -= 1
    c = int(cfg.capacity_factor * B * chunk * K / E)
    cap = max(16, -(-c // 16) * 16)
    groups = x.reshape(B, S // chunk, chunk, D).transpose(1, 0, 2, 3) \
        .reshape(S // chunk, B * chunk, D)
    out = []
    for xg in groups:
        probs = jax.nn.softmax((jnp.asarray(xg) @ router).astype(
            jnp.float32), axis=-1)
        _, idx = jax.lax.top_k(probs, K)
        pos = jnp.cumsum(jax.nn.one_hot(idx, E).reshape(-1, E), 0) - 1.0
        pos = jnp.take_along_axis(pos.reshape(-1, K, E), idx[..., None],
                                  axis=-1)[..., 0]
        out.append(np.asarray(pos >= cap))
    return np.stack(out).reshape(S // chunk, B, chunk, K) \
        .transpose(1, 0, 2, 3).reshape(B, S, K)


def _skewed(block, cfg, B, S, seed=0):
    """Inputs with a shared direction u and a router whose expert 0 reads
    it: every token picks expert 0, whose queue overflows its capacity."""
    rng = np.random.default_rng(seed)
    D = cfg.d_model
    u = rng.standard_normal(D).astype(np.float32)
    u /= np.linalg.norm(u)
    x = (0.3 * rng.standard_normal((B, S, D)) + u).astype(np.float32)
    block = dict(block)
    router = block["router"].copy()
    router[:, 0] += 1.5 * u
    block["router"] = router
    return block, x


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_match_reference(arch, impl, shape):
    jcfg, tcfg = _cfgs(arch)
    B, S = SHAPES[shape]
    block, x = _skewed(_moe_block(arch, jcfg), jcfg, B, S)
    jp, tp = _both(block)
    want = np.asarray(j_moe(jp, jnp.asarray(x), jcfg, impl))
    got = TL.moe(tp, torch.from_numpy(x), tcfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    dropped = TL.moe_dropped(tp, torch.from_numpy(x), tcfg, impl=impl)
    want_dropped = _ref_dropped(jp["router"], x, jcfg, impl)
    assert want_dropped.any() and not want_dropped.all()
    np.testing.assert_array_equal(dropped.numpy(), want_dropped)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_impls_agree_lossless(arch):
    jcfg, tcfg = _cfgs(arch, capacity_factor=8.0)
    jp, tp = _both(_moe_block(arch, jcfg))
    x = np.asarray(0.3 * jax.random.normal(jax.random.PRNGKey(5),
                                           (2, 16, jcfg.d_model)))
    xt = torch.from_numpy(x.copy())
    want = np.asarray(j_moe(jp, jnp.asarray(x), jcfg, "onehot"))
    outs = {impl: TL.moe(tp, xt, tcfg, impl=impl).numpy() for impl in IMPLS}
    for impl in IMPLS:
        np.testing.assert_allclose(outs[impl], outs["onehot"], atol=1e-5)
        np.testing.assert_allclose(outs[impl], want, atol=1e-5)
        assert not TL.moe_dropped(tp, xt, tcfg, impl=impl).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_within_reference_bound(arch):
    """In bfloat16 (lossless capacity, so that a token's output depends on
    its own routing alone), every path against the reference, token by
    token.  The reference rounds the router logits to bf16; compiled
    (``onehot``'s ``lax.map``) XLA keeps them in float32, so a near-tied
    token can route otherwise there.  Where the port, the rounded and the
    unrounded logits choose the same experts, the outputs agree within
    3e-2 of the largest value; every other token must have had its k-th
    and (k+1)-th rounded logits within two bf16 steps: a near-tie, not a
    routing fault."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=8.0)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    jp, tp = _both(_moe_block(arch, jcfg))
    B, S, K = 2, 64, jcfg.top_k
    x = np.random.default_rng(4).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    xf, router = jx.reshape(B * S, -1), jp["router"].astype(jnp.bfloat16)
    vals, rounded = jax.lax.top_k((xf @ router).astype(jnp.float32), K + 1)
    _, unrounded = jax.lax.top_k(
        jnp.dot(xf, router, preferred_element_type=jnp.float32), K)
    _, port = TL.route(tp["router"], tx.reshape(B * S, -1), K)
    chosen = lambda e: np.sort(np.asarray(e)[:, :K], 1)
    same = ((chosen(rounded) == chosen(port.numpy())).all(1)
            & (chosen(rounded) == chosen(unrounded)).all(1))
    vals = np.asarray(vals)
    gap = vals[:, K - 1] - vals[:, K]
    assert (gap[~same] <= 2 * 2.0 ** -7 * np.abs(vals[~same, K - 1])).all()
    for impl in IMPLS:
        want = np.asarray(JL.moe(jp, jx, jcfg, impl).astype(jnp.float32))
        got = TL.moe(tp, tx, tcfg, impl=impl).float().numpy()
        err = np.abs(got - want).reshape(B * S, -1).max(1)
        assert err[same].max() < 3e-2 * np.abs(want).max(), impl


@pytest.mark.parametrize("arch", ARCHS)
def test_topk_ties_follow_lax_top_k(arch):
    """Duplicated router columns and one-hot token rows: each token's
    logits are router rows exactly in both packages, so pairs of experts
    tie bit for bit; the port must choose ``lax.top_k``'s experts (lower
    index first) and give the reference's output."""
    jcfg, tcfg = _cfgs(arch)
    block = dict(_moe_block(arch, jcfg))
    E, D = jcfg.n_experts, jcfg.d_model
    router = np.round(block["router"] * 100) / 100
    router[:, 1::2] = router[:, 0::2]
    block["router"] = router.astype(np.float32)
    jp, tp = _both(block)
    x = np.eye(D, dtype=np.float32).reshape(2, D // 2, D)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(D, D)) @ jp["router"],
                           axis=-1)
    vals, want = jax.lax.top_k(probs, jcfg.top_k)
    assert bool((vals[:, 0] == vals[:, 1]).all())       # the top two tie
    _, got = TL.route(tp["router"], torch.from_numpy(x.reshape(D, D)),
                      tcfg.top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for impl in IMPLS:
        np.testing.assert_allclose(
            TL.moe(tp, torch.from_numpy(x), tcfg, impl=impl).numpy(),
            np.asarray(j_moe(jp, jnp.asarray(x), jcfg, impl)), atol=1e-5)


def test_route_ties_as_lax_top_k_not_torch_topk():
    """The probabilities [.1, .3, .3, .2, .3, .1]: ``lax.top_k(., 3)``
    gives experts [1, 2, 4] (``torch.topk`` may order the tie otherwise)."""
    p = np.array([.1, .3, .3, .2, .3, .1], np.float32)
    logits = np.log(p)[None, :]
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), 3)
    _, got = TL.route(torch.from_numpy(logits), torch.ones((1, 1)), 3)
    assert np.asarray(want).tolist() == [[1, 2, 4]]
    assert got.tolist() == [[1, 2, 4]]


@pytest.mark.parametrize("arch,B,S,path,cap,chunk", [
    # serving at 8 x 1024: prefill on the expert-parallel path, decode
    # (8 tokens) on the sort path with the floor of 16 slots
    ("olmoe-1b-7b", 8, 1024, "ep", 1280, 1024),
    ("deepseek-v2-236b", 8, 1024, "ep", 384, 1024),
    ("olmoe-1b-7b", 8, 1, "sort", 16, 1),
    ("deepseek-v2-236b", 8, 1, "sort", 16, 1),
    ("olmoe-1b-7b", 2, 2048, "ep", 640, 2048)])
def test_moe_plan_capacities(arch, B, S, path, cap, chunk):
    assert TL.moe_plan(tconfigs.get(arch), B, S) == (path, cap, chunk)


def test_moe_plan_onehot_groups_and_unknown_impl():
    cfg = tconfigs.get("olmoe-1b-7b")     # moe_group_tokens 512
    # 512 // 8 = 64 tokens of each sequence a group: 512 tokens, cap
    # int(1.25 * 512 * 8 / 64) = 80
    assert TL.moe_plan(cfg, 8, 1024, "onehot") == ("onehot", 80, 64)
    # the chunk is the largest divisor of S up to 64: 60 for S = 300
    assert TL.moe_plan(cfg, 8, 300, "onehot") == ("onehot", 80, 60)
    with pytest.raises(ValueError, match="unknown MoE impl"):
        TL.moe_plan(cfg, 8, 1, "dense")
