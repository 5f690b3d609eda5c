"""Recurrent blocks of the PyTorch port against the JAX package
(``repro.models.ssm``): the causal convolution, the mLSTM cell
(sequential and chunkwise), the mLSTM, sLSTM and mamba blocks, each from
no state (the stabilizer m at -inf) and from a cache state (zeros, as a
prefill into ``serve.cache.zeros`` starts: m at 0; or random), and the
float32 leaves and ``"ones"`` initialization.  The same numpy-seeded
inputs and weights go through both packages.

Tolerances: float32 rtol 1e-4 / atol 1e-4 (2e-4 for the chunkwise and
doubling scans, which sum in another order than the reference's
``lax.scan`` / ``associative_scan``); new states at the same bounds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL, ssm as J
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL, model as TM, ssm as T
from repro_torch.serve import cache as TC

B, H, DK, DV = 2, 4, 16, 32


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _np(x) -> np.ndarray:
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        jnp.asarray(x, jnp.float32))


def _close(got, want, tol: float = 1e-4) -> None:
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cell_inputs(T_: int, seed: int = 0):
    r = _rng(seed)
    q = r.standard_normal((B, T_, H, DK)).astype(np.float32)
    k = r.standard_normal((B, T_, H, DK)).astype(np.float32)
    v = r.standard_normal((B, T_, H, DV)).astype(np.float32)
    i_raw = r.standard_normal((B, T_, H)).astype(np.float32)
    lf = -np.logaddexp(0.0, -r.standard_normal((B, T_, H))).astype(
        np.float32)
    return q, k, v, i_raw, lf


def _cell_state(kind: str, seed: int = 1):
    """None, zeros (a fresh cache: m = 0) or a random state."""
    if kind == "none":
        return None
    r = _rng(seed)
    shapes = ((B, H, DK, DV), (B, H, DK), (B, H))
    if kind == "zeros":
        return tuple(np.zeros(s, np.float32) for s in shapes)
    return tuple(r.standard_normal(s).astype(np.float32) for s in shapes)


def _both(tree):
    """(jax tree, torch tree) of a numpy tree (None stays None)."""
    if tree is None:
        return None, None
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(tree, tuple):
        pairs = [_both(v) for v in tree]
        return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)
    return jnp.asarray(tree), torch.as_tensor(np.array(tree))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    r = _rng(3)
    x = r.standard_normal((B, 9, 24)).astype(np.float32)
    w = r.standard_normal((4, 24)).astype(np.float32)
    st = r.standard_normal((B, 3, 24)).astype(np.float32) \
        if with_state else None
    (jx, tx), (jw, tw), (js, ts) = _both(x), _both(w), _both(st)
    yj, sj = J.causal_conv1d(jx, jw, js)
    yt, s_t = T.causal_conv1d(tx, tw, ts)
    _close(yt, yj, 1e-5)
    _close(s_t, sj, 0.0)
    # one step at a time, each from the state the last returned
    state, ys = ts, []
    for t in range(x.shape[1]):
        y, state = T.causal_conv1d(tx[:, t:t + 1], tw, state)
        ys.append(y)
    _close(torch.cat(ys, 1), yt, 1e-5)
    _close(state, sj, 0.0)


@pytest.mark.parametrize("state", ["none", "zeros", "random"])
def test_mlstm_sequential_matches_reference(state):
    ins = _cell_inputs(16)
    js, ts = _both(_cell_state(state))
    hj, sj = J.mlstm_sequential(*map(jnp.asarray, ins), js)
    ht, st = T.mlstm_sequential(*map(torch.as_tensor, ins), ts)
    _close(ht, hj)
    for a, b in zip(st, sj):
        _close(a, b)


@pytest.mark.parametrize("state", ["none", "zeros", "random"])
def test_mlstm_chunkwise_matches_reference_and_sequential(state):
    ins = _cell_inputs(64, seed=4)
    js, ts = _both(_cell_state(state, seed=5))
    hj, sj = J.mlstm_chunkwise(*map(jnp.asarray, ins), js, chunk=16)
    ht, st = T.mlstm_chunkwise(*map(torch.as_tensor, ins), ts, chunk=16)
    _close(ht, hj, 2e-4)
    for a, b in zip(st, sj):
        _close(a, b, 2e-4)
    # the reference's own check (tests/test_models.py): chunkwise ==
    # the exact recurrence
    hs, ss = T.mlstm_sequential(*map(torch.as_tensor, ins), ts)
    np.testing.assert_allclose(_np(ht), _np(hs), atol=2e-4)
    np.testing.assert_allclose(_np(st[0]), _np(ss[0]), atol=2e-4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        T.mlstm_chunkwise(*map(torch.as_tensor, _cell_inputs(20)), chunk=16)


def _block_params(arch: str, init):
    """(cfg pair, jax params, torch params) of one smoke block made by the
    reference's ``init`` (key 0), norm scales and biases randomized."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
    ini = JL.Init(jax.random.PRNGKey(0))
    init(ini, jcfg)
    r = _rng(6)
    tree = {k: (0.1 * r.standard_normal(v.shape)).astype(np.float32)
            if v.ndim == 1 else np.asarray(v)
            for k, v in ini.params.items()}
    jp, _ = _both(tree)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}
    return jcfg, tcfg, jp, tp


def _rand_state(spec_tree, seed: int, zeros: bool):
    """A numpy state for a cache spec tree (one batch slice)."""
    r = _rng(seed)
    return TC.tmap(lambda s: np.zeros(s.shape, np.float32) if zeros else
                   r.standard_normal(s.shape).astype(np.float32), spec_tree)


def _run_block(kind, jfn, tfn, arch, init, T_, state, **kw):
    jcfg, tcfg, jp, tp = _block_params(arch, init)
    x = 0.5 * _rng(7).standard_normal((B, T_, jcfg.d_model)).astype(
        np.float32)
    st = None if state == "none" else _rand_state(
        TC.block_cache_spec(tcfg, kind, B, 64)
        if kind != "mamba" else TC._mamba_spec(tcfg, B), 8,
        state == "zeros")
    js, ts = _both(st)
    yj, nj = jfn(jp, jnp.asarray(x), jcfg, state=js, **kw)
    yt = tfn(tp, torch.as_tensor(x), tcfg, state=ts, **kw)
    return yj, yt, nj, ts


def _close_state(got, want, tol):
    for a, b in zip(TC.leaves(got), jax.tree_util.tree_leaves(want)):
        _close(a, b, tol)


@pytest.mark.parametrize("T_,state", [(17, "none"), (17, "zeros"),
                                      (128, "none"), (128, "random"),
                                      (1, "random")])
def test_mlstm_block_matches_reference(T_, state):
    """T = 17 and 1 take the sequential cell, 128 the chunkwise one (its
    chunk); the new state is written into the cache slice in place."""
    yj, yt, nj, ts = _run_block("mlstm", J.mlstm_block, T.mlstm_block,
                                "xlstm-1.3b", J.init_mlstm_block, T_, state)
    _close(yt, yj, 2e-4)
    if ts is not None:
        _close_state(ts, nj, 2e-4)


@pytest.mark.parametrize("T_,state", [(17, "none"), (17, "zeros"),
                                      (1, "random")])
def test_slstm_block_matches_reference(T_, state):
    yj, yt, nj, ts = _run_block("slstm", J.slstm_block, T.slstm_block,
                                "xlstm-1.3b", J.init_slstm_block, T_, state)
    _close(yt, yj)
    if ts is not None:
        _close_state(ts, nj, 1e-4)


@pytest.mark.parametrize("T_,state", [(1, "random"), (1, "none"),
                                      (256, "none"), (256, "zeros"),
                                      (150, "random")])
def test_mamba_matches_reference(T_, state):
    """T = 1 takes the single step; 256 two chunks of 128 (T divisible by
    the chunk); 150 two chunks of 75 (the chunk a divisor below 128)."""
    init = lambda ini, cfg: J.init_mamba(ini, cfg, prefix="m_")
    yj, yt, nj, ts = _run_block("mamba", J.mamba, T.mamba, "hymba-1.5b",
                                init, T_, state, prefix="m_")
    _close(yt, yj, 2e-4)
    if ts is not None:
        _close_state(ts, nj, 2e-4)


def test_mamba_chunk_and_doubling_scan():
    assert [T.mamba_chunk(t) for t in (1024, 1023, 256, 150, 64, 131)] \
        == [128, 93, 128, 75, 64, 1]
    r = _rng(9)
    a = torch.as_tensor(r.uniform(0.5, 1.0, (2, 13, 3, 4)))
    b = torch.as_tensor(r.standard_normal((2, 13, 3, 4)))
    want, h = [], torch.zeros_like(b[:, 0])
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = T._doubling_scan(a.clone(), b.clone())
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


F32_MATRICES = ("mamba_A_log", "rz", "ri", "rf", "ro")


def _carried(arch: str):
    """(reference tree as numpy, the port's bf16 model carried from it)."""
    from repro.models import model as JM
    params, _ = JM.init_model(jconfigs.get_smoke(arch), jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return tree, TM.params_from_numpy(tconfigs.get_smoke(arch), tree,
                                      device="cpu")


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_float32_leaves_and_ones_init(arch):
    """``A_log`` and sLSTM's ``r*`` stay float32 in a bf16 model, from
    ``init_model`` and from ``params_from_numpy``; ``A_log`` and
    ``D_skip`` are made as ones; the other matrices are bf16."""
    cfg = tconfigs.get_smoke(arch)
    assert cfg.dtype == "bfloat16"
    made = TM.init_model(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    for model in (made, _carried(arch)[1]):
        f32 = set()
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            f32_leaf = leaf in F32_MATRICES
            assert p.dtype == (torch.float32 if p.dim() == 1 or f32_leaf
                               else torch.bfloat16), name
            if f32_leaf:
                f32.add(leaf)
            if model is made and leaf in ("mamba_A_log", "mamba_D_skip"):
                assert bool((p == 1).all()), name
        assert f32 == ({"mamba_A_log"} if arch == "hymba-1.5b"
                       else {"rz", "ri", "rf", "ro"})
    assert TL.leaf_dtype("attn_wq", 2, torch.bfloat16) == torch.bfloat16


@pytest.mark.parametrize("arch,leaf", [("xlstm-1.3b", "rz"),
                                       ("hymba-1.5b", "mamba_A_log")])
def test_float32_leaves_carried_exactly(arch, leaf):
    """A float32 leaf carried from the reference keeps its values, which
    bf16 would round (the reference reads it in float32)."""
    tree, carried = _carried(arch)
    j = TM.layer_plan(tconfigs.get_smoke(arch))[0].kinds.index(
        "slstm" if leaf == "rz" else "hymba_global")
    want = tree["g0"][f"b{j}"][leaf][0]
    if leaf == "mamba_A_log":   # made as ones: perturb to see a rounding
        want = want + 1e-3 * _rng(10).standard_normal(want.shape).astype(
            np.float32)
        stacked = np.array(tree["g0"][f"b{j}"][leaf])
        stacked[0] = want
        tree["g0"][f"b{j}"][leaf] = stacked
        carried = TM.params_from_numpy(tconfigs.get_smoke(arch), tree,
                                       device="cpu")
    np.testing.assert_array_equal(
        carried.groups[0][0][f"b{j}"][leaf].numpy(), want)
    assert not np.array_equal(
        torch.tensor(want).bfloat16().float().numpy(), want)
