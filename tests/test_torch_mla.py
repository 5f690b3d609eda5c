"""MLA of the PyTorch port against the JAX package's ``mla_attention``,
then the MoE family end to end: the deepseek-v2-236b and olmoe-1b-7b
smoke models, the JAX weights carried across (``params_from_numpy``).

MLA cases (deepseek's smoke block, float32): no cache (the expanded path
through ``attend``); a prefill into the compressed cache (the cache
leaves equal the reference's new cache); decode steps of 1 and 3 tokens
against it (the absorbed path, in the compressed space).  End to end:
``forward_hidden``, prefill and decode logits, greedy ids; cached decode
of the last prompt token against the forward pass at the reference's
lossless capacity; in bfloat16, each block against the reference's.
On the meta device, the q, k and v that deepseek's full-width prefill
hands ``attend``, and the kernel the dispatch picks for them (wgmma).

Tolerances: float32 rtol 1e-4 / atol 1e-4 (the same arithmetic summed in
another order); greedy ids equal; cached decode, and bfloat16 blocks,
within 3e-2 of the largest value (the reference's own bound for cached
decode, ``tests/test_models.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL, model as JM
from repro.serve import cache as JC, engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL, model as TM
from repro_torch.serve import cache as TC, engine as tengine

ARCHS = ("deepseek-v2-236b", "olmoe-1b-7b")
B, S, GEN = 2, 16, 8
SMAX = S + GEN + 8
TOL = dict(rtol=1e-4, atol=1e-4)
j_mla = jax.jit(JL.mla_attention, static_argnums=2)
j_forward = jax.jit(JM.forward_hidden, static_argnums=1)
j_prefill = jax.jit(jengine.prefill, static_argnums=1)
j_decode = jax.jit(jengine.decode_step, static_argnums=1)
j_generate = jax.jit(jengine.greedy_generate, static_argnums=(1, 4))


def _noisy(tree, rng):
    """The JAX tree as numpy, with random norm scales (the init's are zero,
    which would hide a wrong ``1 + scale``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _noisy(v, rng)
        elif "norm" in k or k in ("ln1", "ln2"):
            out[k] = (0.1 * rng.standard_normal(np.shape(v))).astype(
                np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _pair(arch: str, dtype: str):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(1))
    tree = _noisy(params, np.random.default_rng(2))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            TM.params_from_numpy(tcfg, tree, device="cpu"))


def _np(x) -> np.ndarray:
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        jnp.asarray(x, jnp.float32))


def _tokens(vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def mla_block():
    """deepseek's smoke ``mla_dense`` block (float32): the JAX params, the
    port's, the two configs."""
    jcfg, jparams, tcfg, model = _pair("deepseek-v2-236b", "float32")
    jblock = jax.tree_util.tree_map(lambda a: a[0], jparams["g0"]["b0"])
    return jcfg, jblock, tcfg, model.groups[0][0]["b0"]


def _x(cfg, n: int, seed: int) -> np.ndarray:
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model))).astype(np.float32)


def _pos(start: int, n: int):
    return (jnp.arange(start, start + n, dtype=jnp.int32),
            torch.arange(start, start + n, dtype=torch.int32))


def test_mla_no_cache(mla_block):
    jcfg, jp, tcfg, tp = mla_block
    x = _x(jcfg, S, 0)
    jpos, tpos = _pos(0, S)
    want, jc = j_mla(jp, jnp.asarray(x), jcfg, positions=jpos)
    got, tc = TL.mla_attention(tp, torch.from_numpy(x), tcfg,
                               positions=tpos)
    assert jc is None and tc is None
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _prefilled(jcfg, jp, tcfg, tp, n: int):
    """Both packages' caches after a prefill of ``n`` tokens, and their
    outputs."""
    x = _x(jcfg, n, 1)
    jpos, tpos = _pos(0, n)
    jcache = JC.zeros(JC.cache_spec(jcfg, B, SMAX, dtype=jnp.float32))[0]
    tcache = TC.zeros(TC.cache_spec(tcfg, B, SMAX, dtype=torch.float32),
                      device="cpu")[0]
    jc = jax.tree_util.tree_map(lambda a: a[0], jcache["b0"])
    tc = {k: v[0] for k, v in tcache["b0"].items()}
    jy, jc = j_mla(jp, jnp.asarray(x), jcfg, positions=jpos, cache=jc)
    ty, tc = TL.mla_attention(tp, torch.from_numpy(x), tcfg, positions=tpos,
                              cache=tc)
    return jy, jc, ty, tc


def _assert_cache_equal(jc, tc):
    assert sorted(jc) == sorted(tc) == ["c_kv", "k_rope", "pos_ids"]
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)
    np.testing.assert_array_equal(tc["pos_ids"].numpy(),
                                  np.asarray(jc["pos_ids"]))


def test_mla_prefill_into_cache(mla_block):
    jcfg, jp, tcfg, tp = mla_block
    jy, jc, ty, tc = _prefilled(jcfg, jp, tcfg, tp, S)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _assert_cache_equal(jc, tc)
    assert tc["c_kv"].shape == (B, SMAX, tcfg.kv_lora_rank)
    assert bool((tc["pos_ids"][S:] == -1).all())


@pytest.mark.parametrize("n_new", [1, 3])
def test_mla_absorbed_decode(mla_block, n_new):
    """Decode steps of ``n_new`` <= 8 tokens against a prefilled cache take
    the absorbed path in both packages."""
    jcfg, jp, tcfg, tp = mla_block
    _, jc, _, tc = _prefilled(jcfg, jp, tcfg, tp, S)
    x = _x(jcfg, n_new, 2)
    jpos, tpos = _pos(S, n_new)
    jy, jc = j_mla(jp, jnp.asarray(x), jcfg, positions=jpos, cache=jc)
    ty, tc = TL.mla_attention(tp, torch.from_numpy(x), tcfg, positions=tpos,
                              cache=tc)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _assert_cache_equal(jc, tc)


@pytest.fixture(scope="module", params=ARCHS)
def f32_pair(request):
    return _pair(request.param, "float32")


def test_forward_prefill_decode_match_f32(f32_pair):
    jcfg, jparams, tcfg, model = f32_pair
    toks = _tokens(jcfg.vocab)
    jtok, ttok = jnp.asarray(toks), torch.as_tensor(toks)
    h_j = j_forward(jparams, jcfg, {"tokens": jtok})
    h_t = TM.forward_hidden(model, tcfg, {"tokens": ttok})
    np.testing.assert_allclose(_np(h_t), _np(h_j), **TOL)
    jcache = JC.zeros(JC.cache_spec(jcfg, B, SMAX, dtype=jnp.float32))
    tcache = TC.zeros(TC.cache_spec(tcfg, B, SMAX, dtype=torch.float32),
                      device="cpu")
    lj, jcache = j_prefill(jparams, jcfg, {"tokens": jtok[:, :-1]}, jcache)
    lt, tcache = tengine.prefill(model, tcfg, {"tokens": ttok[:, :-1]},
                                 tcache)
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    dj, _ = j_decode(jparams, jcfg, jtok[:, -1:],
                     jnp.asarray(S - 1, jnp.int32), jcache)
    dt, _ = tengine.decode_step(model, tcfg, ttok[:, -1:], S - 1, tcache)
    np.testing.assert_allclose(_np(dt), _np(dj), **TOL)


def test_greedy_generate_ids_equal_f32(f32_pair):
    jcfg, jparams, tcfg, model = f32_pair
    toks = _tokens(jcfg.vocab, seed=5)
    jseq, _ = j_generate(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                         JC.zeros(JC.cache_spec(jcfg, B, SMAX,
                                                dtype=jnp.float32)), GEN)
    tseq, _ = tengine.greedy_generate(
        model, tcfg, {"tokens": torch.as_tensor(toks)},
        TC.zeros(TC.cache_spec(tcfg, B, SMAX, dtype=torch.float32),
                 device="cpu"), GEN)
    assert tseq.dtype == torch.int32 and tseq.shape == (B, GEN)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_decode_vs_forward_f32(arch):
    """Cached decode of the last prompt token against the uncached forward
    pass as the reference's test holds it (``tests/test_models.py``): in
    float32, so that near-tie routing cannot flip between the two paths,
    at the lossless capacity factor 8.0 (at 1.25 the forward pass's 32
    tokens and the decode step's 2 fill the experts' queues differently,
    so their drops differ)."""
    _, _, tcfg, model = _pair(arch, "float32")
    tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    ttok = torch.as_tensor(_tokens(tcfg.vocab, seed=3))
    h = TM.forward_hidden(model, tcfg, {"tokens": ttok})
    ref = TM.logits_fn(model, tcfg, h[:, -1:])[:, 0]
    cache = TC.zeros(TC.cache_spec(tcfg, B, SMAX, dtype=torch.float32),
                     device="cpu")
    _, cache = tengine.prefill(model, tcfg, {"tokens": ttok[:, :-1]}, cache)
    got, _ = tengine.decode_step(model, tcfg, ttok[:, -1:], S - 1, cache)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    assert float((got - ref).abs().max() / ref.abs().max()) < 3e-2


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_mla_prefill_attend_takes_the_wgmma_kernel(monkeypatch):
    """deepseek-v2-236b's full-width MLA block, prefilling 8 x 1024 tokens
    into a cache of 1064 slots, on the meta device (shapes only): the
    expanded q, k and v it passes to ``attend`` are contiguous bf16 at D
    192 / Dv 128, and the dispatch sends them to the wgmma kernel."""
    from repro_torch.kernels import flash_attention as tfa
    cfg = dataclasses.replace(tconfigs.get("deepseek-v2-236b"), n_layers=1)
    block = TM.init_model(cfg, device="meta").groups[0][0]["b0"]
    seen = []

    def record(q, k, v, **kw):
        seen.append((q, k, v))
        return torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                           device=q.device)

    monkeypatch.setattr(TL, "attend", record)
    n, s, smax = 8, 1024, 1064
    cache = TC.zeros(TC.cache_spec(cfg, n, smax), device="meta")[0]["b0"]
    x = torch.empty((n, s, cfg.d_model), dtype=torch.bfloat16, device="meta")
    y, _ = TL.mla_attention(
        block, x, cfg, positions=torch.arange(s, dtype=torch.int32,
                                              device="meta"),
        cache={k: v[0] for k, v in cache.items()})
    assert y.shape == (n, s, cfg.d_model)
    (q, k, v), = seen
    H = cfg.n_heads
    assert q.shape == (n, s, H, 192) and k.shape == (n, smax, H, 192)
    assert v.shape == (n, smax, H, 128)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous()
               for t in (q, k, v))
    rows = s * H // k.shape[2]
    assert tfa.choose_kernel(q.dtype, q.shape[-1], v.shape[-1],
                             rows) == "wgmma"


def test_mla_bf16_within_reference_bound():
    """In bfloat16, deepseek's ``mla_dense`` block against the reference
    on the same input: no cache, a prefill into the cache and an absorbed
    decode step (the whole bf16 models are not compared: their MoE routing
    is ill-conditioned in bf16, ``tests/test_torch_moe.py``)."""
    jcfg, jparams, tcfg, model = _pair("deepseek-v2-236b", "bfloat16")
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["g0"]["b0"])
    tp = model.groups[0][0]["b0"]
    x = _x(jcfg, S, 4)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    jpos, tpos = _pos(0, S)
    want, _ = j_mla(jp, jx, jcfg, positions=jpos)
    got, _ = TL.mla_attention(tp, tx, tcfg, positions=tpos)
    assert _rel(got, want) < 3e-2
    jc = jax.tree_util.tree_map(lambda a: a[0], JC.zeros(JC.cache_spec(
        jcfg, B, SMAX))[0]["b0"])
    tc = {k: v[0] for k, v in TC.zeros(TC.cache_spec(tcfg, B, SMAX),
                                       device="cpu")[0]["b0"].items()}
    for start, n in ((0, S - 1), (S - 1, 1)):      # prefill, then decode
        jpos, tpos = _pos(start, n)
        want, jc = j_mla(jp, jx[:, start:start + n], jcfg, positions=jpos,
                         cache=jc)
        got, tc = TL.mla_attention(tp, tx[:, start:start + n], tcfg,
                                   positions=tpos, cache=tc)
        assert _rel(got, want) < 3e-2
        assert _rel(tc["c_kv"], jc["c_kv"]) < 3e-2
