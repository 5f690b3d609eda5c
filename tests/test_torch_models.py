"""Model-serving slice of the PyTorch port against the JAX package: the
qwen3-4b smoke configuration with the JAX weights carried across
(``params_from_numpy``), h2o-danube-3-4b at narrow width with its head
dim of 120 and a window that bites, the recurrent ones (xlstm-1.3b,
hymba-1.5b) end to end, the KV-cache and recurrent-state specs,
parameter counts and costs (the MoE family's and the recurrent ones'
too), the architecture-to-VSR bridge, and the serving CLI.

Tolerances: float32 logits and hidden states rtol 1e-4 / atol 1e-4 (the
same arithmetic, summed in another order); greedy ids equal; bfloat16
logits within 3e-2 of the largest logit (the reference's own bound for
cached decode, tests/test_models.py); VSR arrays rtol 1e-6."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import vsr as jvsr
from repro.models import costs as jcosts, model as JM
from repro.serve import cache as JC, engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.core import vsr as tvsr
from repro_torch.models import costs as tcosts, model as TM
from repro_torch.serve import cache as TC, engine as tengine

DENSE = ("qwen3-4b", "h2o-danube-3-4b", "gemma2-27b", "command-r-plus-104b")
# the architectures the port serves: the dense ones and the MoE family
# (tests/test_torch_moe.py and tests/test_torch_mla.py hold its blocks)
SERVED = DENSE + ("olmoe-1b-7b", "deepseek-v2-236b")
# the recurrent architectures (tests/test_torch_ssm.py holds their blocks)
RECURRENT = ("xlstm-1.3b", "hymba-1.5b")
# whisper's encoder-decoder and internvl2's patch prefix
# (tests/test_torch_encdec.py holds them end to end)
ENCDEC = ("whisper-base", "internvl2-2b")
SERVED = SERVED + RECURRENT + ENCDEC
B, S, GEN = 2, 16, 8
# the reference's entry points, compiled (cfg and n_steps static)
j_forward = jax.jit(JM.forward_hidden, static_argnums=1)
j_prefill = jax.jit(jengine.prefill, static_argnums=1)
j_decode = jax.jit(jengine.decode_step, static_argnums=1)
j_generate = jax.jit(jengine.greedy_generate, static_argnums=(1, 4))


def _with_norm_noise(tree, rng):
    """The JAX tree as numpy, with random norm scales (the init's are zero,
    which would hide a wrong ``1 + scale``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _with_norm_noise(v, rng)
        elif "norm" in k or k in ("ln1", "ln2", "ln_x"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _pair(arch: str, dtype: str, **overrides):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch, **overrides),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch, **overrides),
                               dtype=dtype)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(1))
    tree = _with_norm_noise(params, np.random.default_rng(2))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, TM.params_from_numpy(tcfg, tree, device="cpu")


def _tokens(vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _np(x) -> np.ndarray:
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("qwen3-4b", "float32")


def test_params_from_numpy_layout(f32_pair):
    jcfg, jparams, tcfg, model = f32_pair
    assert TM.param_count(model) == JM.param_count(jparams)
    blk = model.groups[0][1]["b0"]
    np.testing.assert_array_equal(blk["wq"].numpy(),
                                  np.asarray(jparams["g0"]["b0"]["wq"][1]))
    assert blk["q_norm"].dtype == torch.float32
    assert not any(p.requires_grad for p in model.parameters())


def test_forward_prefill_decode_match_f32(f32_pair):
    jcfg, jparams, tcfg, model = f32_pair
    toks = _tokens(jcfg.vocab)
    jtok, ttok = jnp.asarray(toks), torch.as_tensor(toks)
    h_j = j_forward(jparams, jcfg, {"tokens": jtok})
    h_t = TM.forward_hidden(model, tcfg, {"tokens": ttok})
    np.testing.assert_allclose(_np(h_t), _np(h_j), rtol=1e-4, atol=1e-4)

    max_len = S + GEN + 8
    jcache = JC.zeros(JC.cache_spec(jcfg, B, max_len, dtype=jnp.float32))
    tcache = TC.zeros(TC.cache_spec(tcfg, B, max_len, dtype=torch.float32),
                      device="cpu")
    lj, jcache = j_prefill(jparams, jcfg, {"tokens": jtok[:, :-1]}, jcache)
    lt, tcache = tengine.prefill(model, tcfg, {"tokens": ttok[:, :-1]},
                                 tcache)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-4, atol=1e-4)
    dj, _ = j_decode(jparams, jcfg, jtok[:, -1:],
                     jnp.asarray(S - 1, jnp.int32), jcache)
    dt, _ = tengine.decode_step(model, tcfg, ttok[:, -1:], S - 1, tcache)
    np.testing.assert_allclose(_np(dt), _np(dj), rtol=1e-4, atol=1e-4)
    # cached decode of the last token == the uncached forward's last logits
    ref = TM.logits_fn(model, tcfg, h_t[:, -1:])[:, 0]
    np.testing.assert_allclose(_np(dt), _np(ref), rtol=1e-4, atol=1e-4)
    pos = tcache[0]["b0"]["pos_ids"]
    assert pos.dtype == torch.int32
    assert torch.equal(pos[0, :S], torch.arange(S, dtype=torch.int32))
    assert bool((pos[:, S:] == -1).all())


def test_greedy_generate_ids_equal_f32(f32_pair):
    jcfg, jparams, tcfg, model = f32_pair
    toks = _tokens(jcfg.vocab, seed=5)
    max_len = S + GEN + 8
    jseq, _ = j_generate(
        jparams, jcfg, {"tokens": jnp.asarray(toks)},
        JC.zeros(JC.cache_spec(jcfg, B, max_len)), GEN)
    tseq, _ = tengine.greedy_generate(
        model, tcfg, {"tokens": torch.as_tensor(toks)},
        TC.zeros(TC.cache_spec(tcfg, B, max_len, dtype=torch.float32),
                 device="cpu"), GEN)
    assert tseq.dtype == torch.int32 and tseq.shape == (B, GEN)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))


def test_prefill_decode_bf16_within_reference_bound():
    jcfg, jparams, tcfg, model = _pair("qwen3-4b", "bfloat16")
    toks = _tokens(jcfg.vocab, seed=3)
    jtok, ttok = jnp.asarray(toks), torch.as_tensor(toks)
    jcache = JC.zeros(JC.cache_spec(jcfg, B, S + 8))
    tcache = TC.zeros(TC.cache_spec(tcfg, B, S + 8), device="cpu")
    lj, jcache = j_prefill(jparams, jcfg, {"tokens": jtok[:, :-1]}, jcache)
    lt, tcache = tengine.prefill(model, tcfg, {"tokens": ttok[:, :-1]},
                                 tcache)
    assert lt.dtype == torch.float32
    assert _rel(lt, lj) < 3e-2
    dj, _ = j_decode(jparams, jcfg, jtok[:, -1:],
                     jnp.asarray(S - 1, jnp.int32), jcache)
    dt, _ = tengine.decode_step(model, tcfg, ttok[:, -1:], S - 1, tcache)
    assert _rel(dt, dj) < 3e-2


# h2o-danube-3-4b at narrow width with its real head dim (120: the wgmma
# kernel's zero-padded boxes on the card): 2 layers, 4 query heads on 1 kv
# head, a 16-slot window, so that a 24-token forward pass and decode steps
# past position 15 (the ring of 16 cache slots wrapped) are windowed
DANUBE_NARROW = dict(n_layers=2, n_heads=4, n_kv_heads=1, d_head=120,
                     sliding_window=16)
DANUBE_PROMPT, DANUBE_STEPS = 16, 8


def test_danube_head_dim_120_matches_reference_f32():
    """The narrow danube against the reference: the forward pass over 24
    tokens (window 16 bites), a 16-token prefill into its ring of 16
    slots, then 8 teacher-forced decode steps that wrap the ring (logits
    at each step, float32 rtol 1e-4 / atol 2e-4); the last step's
    logits against the port's own forward (3e-2 of the largest logit);
    greedy ids equal to the reference's."""
    jcfg, jparams, tcfg, model = _pair("h2o-danube-3-4b", "float32",
                                       **DANUBE_NARROW)
    assert tcfg.head_dim == 120 and tcfg.sliding_window == 16
    P, n = DANUBE_PROMPT, DANUBE_STEPS
    toks = np.random.default_rng(13).integers(0, jcfg.vocab, (B, P + n)) \
        .astype(np.int32)
    jtok, ttok = jnp.asarray(toks), torch.as_tensor(toks)
    h_j = j_forward(jparams, jcfg, {"tokens": jtok})
    h_t = TM.forward_hidden(model, tcfg, {"tokens": ttok})
    np.testing.assert_allclose(_np(h_t), _np(h_j), rtol=1e-4, atol=2e-4)

    max_len = P + n + 8
    jcache = JC.zeros(JC.cache_spec(jcfg, B, max_len, dtype=jnp.float32))
    tcache = TC.zeros(TC.cache_spec(tcfg, B, max_len, dtype=torch.float32),
                      device="cpu")
    assert tcache[0]["b0"]["k"].shape[2] == 16     # [repeats, B, slots, ..]
    lj, jcache = j_prefill(jparams, jcfg, {"tokens": jtok[:, :P]}, jcache)
    lt, tcache = tengine.prefill(model, tcfg, {"tokens": ttok[:, :P]},
                                 tcache)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-4, atol=2e-4)
    for i in range(n):
        dj, jcache = j_decode(jparams, jcfg, jtok[:, P + i:P + i + 1],
                              jnp.asarray(P + i, jnp.int32), jcache)
        dt, tcache = tengine.decode_step(model, tcfg,
                                         ttok[:, P + i:P + i + 1], P + i,
                                         tcache)
        np.testing.assert_allclose(_np(dt), _np(dj), rtol=1e-4, atol=2e-4)
    assert _rel(dt, TM.logits_fn(model, tcfg, h_t[:, -1:])[:, 0]) < 3e-2

    jseq, _ = j_generate(
        jparams, jcfg, {"tokens": jtok[:, :P]},
        JC.zeros(JC.cache_spec(jcfg, B, max_len)), GEN)
    tseq, _ = tengine.greedy_generate(
        model, tcfg, {"tokens": ttok[:, :P]},
        TC.zeros(TC.cache_spec(tcfg, B, max_len, dtype=torch.float32),
                 device="cpu"), GEN)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))


def test_danube_head_dim_120_bf16_within_reference_bound():
    """The narrow danube in bf16: prefill and a decode step past the
    window (the ring wrapped) within 3e-2 of the reference's largest
    logit."""
    jcfg, jparams, tcfg, model = _pair("h2o-danube-3-4b", "bfloat16",
                                       **DANUBE_NARROW)
    P = DANUBE_PROMPT
    toks = np.random.default_rng(17).integers(0, jcfg.vocab, (B, P + 1)) \
        .astype(np.int32)
    jtok, ttok = jnp.asarray(toks), torch.as_tensor(toks)
    jcache = JC.zeros(JC.cache_spec(jcfg, B, P + 8))
    tcache = TC.zeros(TC.cache_spec(tcfg, B, P + 8), device="cpu")
    lj, jcache = j_prefill(jparams, jcfg, {"tokens": jtok[:, :P]}, jcache)
    lt, tcache = tengine.prefill(model, tcfg, {"tokens": ttok[:, :P]},
                                 tcache)
    assert _rel(lt, lj) < 3e-2
    dj, _ = j_decode(jparams, jcfg, jtok[:, P:], jnp.asarray(P, jnp.int32),
                     jcache)
    dt, _ = tengine.decode_step(model, tcfg, ttok[:, P:], P, tcache)
    assert _rel(dt, dj) < 3e-2


# gemma2-27b's smoke configuration (2 layers: local, then global; a
# 64-slot window, attention softcap 50, final softcap 30) past its window:
# an 80-token prompt prefilled whole, past the local layer's ring of 64
# slots (its first 16 positions overwritten within the prefill, each slot
# keeping its last, as the reference's scatter leaves it), then 8 decode
# steps -- the ring wraps again; the forward pass over all 88 tokens masks
# by the window
GEMMA_PREFILL, GEMMA_PROMPT, GEMMA_STEPS = 80, 80, 8


def _gemma_past_window(dtype: str, check) -> None:
    jcfg, jparams, tcfg, model = _pair("gemma2-27b", dtype)
    assert tcfg.sliding_window == 64 and TM.layer_plan(tcfg)[0].kinds == (
        "attn_local", "attn_global")
    P, n = GEMMA_PREFILL, GEMMA_PROMPT + GEMMA_STEPS - GEMMA_PREFILL
    toks = np.random.default_rng(19).integers(0, jcfg.vocab, (B, P + n)) \
        .astype(np.int32)
    jtok, ttok = jnp.asarray(toks), torch.as_tensor(toks)
    check(TM.forward_hidden(model, tcfg, {"tokens": ttok}),
          j_forward(jparams, jcfg, {"tokens": jtok}))
    max_len = GEMMA_PROMPT + GEMMA_STEPS + 8
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcache = JC.zeros(JC.cache_spec(jcfg, B, max_len, dtype=jdt))
    tcache = TC.zeros(TC.cache_spec(tcfg, B, max_len, dtype=tdt),
                      device="cpu")
    assert tcache[0]["b0"]["k"].shape[2] == 64     # the local ring
    assert tcache[0]["b1"]["k"].shape[2] == max_len
    lj, jcache = j_prefill(jparams, jcfg, {"tokens": jtok[:, :P]}, jcache)
    lt, tcache = tengine.prefill(model, tcfg, {"tokens": ttok[:, :P]},
                                 tcache)
    check(lt, lj)
    for i in range(n):
        dj, jcache = j_decode(jparams, jcfg, jtok[:, P + i:P + i + 1],
                              jnp.asarray(P + i, jnp.int32), jcache)
        dt, tcache = tengine.decode_step(model, tcfg,
                                         ttok[:, P + i:P + i + 1], P + i,
                                         tcache)
        check(dt, dj)
    for b in ("b0", "b1"):
        np.testing.assert_array_equal(
            tcache[0][b]["pos_ids"].numpy(),
            np.asarray(jcache[0][b]["pos_ids"]))
    ring = tcache[0]["b0"]["pos_ids"][0]
    assert int(ring.max()) == P + n - 1 and int(ring.min()) == P + n - 64


def test_gemma2_past_window_matches_reference_f32():
    """Smoke gemma2-27b in float32 with norm noise: the forward pass over
    88 tokens, an 80-token prefill past the local layer's 64-slot ring and
    8 decode steps, each against the reference's jitted entry points (rtol
    1e-4 / atol 2e-4); both caches' positions equal."""
    _gemma_past_window("float32", lambda got, want: np.testing.
                       assert_allclose(_np(got), _np(want), rtol=1e-4,
                                       atol=2e-4))


def test_gemma2_past_window_bf16_within_reference_bound():
    """The same in bf16: each output within 3e-2 of the reference's
    largest value."""
    def check(got, want):
        assert _rel(got, want) < 3e-2
    _gemma_past_window("bfloat16", check)


@pytest.mark.parametrize("arch,smoke", [(a, s) for a in SERVED
                                        for s in (True, False)])
def test_cache_spec_matches_reference(arch, smoke):
    get_j = jconfigs.get_smoke if smoke else jconfigs.get
    get_t = tconfigs.get_smoke if smoke else tconfigs.get
    # whisper's cross cache over its 1500 encoder frames
    enc_len = 1500 if get_t(arch).is_encoder_decoder else 0
    jspec = JC.cache_spec(get_j(arch), 8, 1064, enc_len=enc_len)
    tspec = TC.cache_spec(get_t(arch), 8, 1064, enc_len=enc_len)
    jl = jax.tree_util.tree_leaves(jspec, is_leaf=lambda x: isinstance(
        x, JC.TSpec))
    tl = TC.leaves(tspec)
    assert [s.shape for s in tl] == [s.shape for s in jl]
    assert [str(s.dtype).replace("torch.", "") for s in tl] == \
        [jnp.dtype(s.dtype).name for s in jl]
    assert TC.cache_bytes(tspec) == JC.cache_bytes(jspec)


def test_cache_zeros_fill():
    cfg = tconfigs.get_smoke("qwen3-4b")
    c = TC.zeros(TC.cache_spec(cfg, 2, 10), device="cpu")
    assert c[0]["b0"]["k"].dtype == torch.bfloat16
    assert bool((c[0]["b0"]["pos_ids"] == -1).all())
    assert float(c[0]["b0"]["v"].abs().sum()) == 0.0


@pytest.mark.parametrize("arch", SERVED)
def test_param_count_on_meta_matches_reference(arch):
    want = jcosts.param_breakdown(jconfigs.get(arch))
    got = tcosts.param_breakdown(tconfigs.get(arch))
    assert got == want
    assert TM.param_count(TM.init_model(tconfigs.get(arch),
                                        device="meta")) == want["total"]


@pytest.mark.parametrize("arch", SERVED)
def test_from_architecture_matches_reference(arch):
    kw = dict(tokens_per_s=1234.5, n_stages=4, context=1536, source_node=3)
    want = jvsr.from_architecture(jconfigs.get(arch), **kw)
    got = tvsr.from_architecture(tconfigs.get(arch), **kw)
    for f in ("F", "H", "src", "input_vm"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "deepseek-v2-236b")
                         + RECURRENT + ENCDEC)
def test_moe_family_costs_match_reference(arch):
    """The full configs' parameter split (expert, active) and per-layer
    costs on meta, for the MoE family (a MoE layer's experts at top_k /
    n_experts), the recurrent models (no attention term for mLSTM and
    sLSTM layers; hymba's attention and mamba branches from their
    shapes) and whisper / internvl2 (whisper's encoder counted in the
    split, its decoder layers alone, with their cross-attention
    projections, in the costs)."""
    cfg_j, cfg_t = jconfigs.get(arch), tconfigs.get(arch)
    assert tcosts.param_breakdown(cfg_t) == jcosts.param_breakdown(cfg_j)
    for ctx in (2048, 1064):
        got, want = tcosts.layer_costs(cfg_t, ctx), jcosts.layer_costs(
            cfg_j, ctx)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
        assert got[1] == want[1]


# the prompt of the recurrent models' parity test: 128 tokens take
# xlstm's chunkwise mLSTM (one chunk of 128); hymba's 64 fill its smoke
# window's ring buffer (64 slots), so the decode step wraps to slot 0
RECURRENT_PROMPT = {"xlstm-1.3b": 128, "hymba-1.5b": 64}


@pytest.fixture(scope="module", params=RECURRENT)
def recurrent_f32(request):
    return request.param, _pair(request.param, "float32")


def test_recurrent_forward_prefill_decode_match_f32(recurrent_f32):
    """The forward pass from no state (the stabilizer m at -inf), a
    prefill into a zeros cache (m at 0) and one decode step, against the
    reference's ``forward_hidden`` and ``engine``: hidden states, logits
    and every cache leaf (written in place); then the cached decode
    against the port's own forward over the whole sequence (the
    reference's bound, 3e-2 of the largest logit)."""
    arch, (jcfg, jparams, tcfg, model) = recurrent_f32
    P = RECURRENT_PROMPT[arch]
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (B, P + 1)) \
        .astype(np.int32)
    jtok, ttok = jnp.asarray(toks), torch.as_tensor(toks)
    h_j = j_forward(jparams, jcfg, {"tokens": jtok[:, :P]})
    h_t = TM.forward_hidden(model, tcfg, {"tokens": ttok[:, :P]})
    np.testing.assert_allclose(_np(h_t), _np(h_j), rtol=1e-4, atol=2e-4)

    max_len = P + 8
    jcache = JC.zeros(JC.cache_spec(jcfg, B, max_len, dtype=jnp.float32))
    tcache = TC.zeros(TC.cache_spec(tcfg, B, max_len, dtype=torch.float32),
                      device="cpu")
    lj, jcache = j_prefill(jparams, jcfg, {"tokens": jtok[:, :P]}, jcache)
    lt, tcache = tengine.prefill(model, tcfg, {"tokens": ttok[:, :P]},
                                 tcache)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-4, atol=2e-4)
    jleaves = jax.tree_util.tree_leaves(jcache)
    tleaves = TC.leaves(tcache)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=2e-4)
    dj, _ = j_decode(jparams, jcfg, jtok[:, P:], jnp.asarray(P, jnp.int32),
                     jcache)
    dt, tcache = tengine.decode_step(model, tcfg, ttok[:, P:], P, tcache)
    np.testing.assert_allclose(_np(dt), _np(dj), rtol=1e-4, atol=2e-4)
    h_all = TM.forward_hidden(model, tcfg, {"tokens": ttok})
    assert _rel(dt, TM.logits_fn(model, tcfg, h_all[:, -1:])[:, 0]) < 3e-2


def test_recurrent_greedy_generate_ids_equal_f32(recurrent_f32):
    arch, (jcfg, jparams, tcfg, model) = recurrent_f32
    toks = _tokens(jcfg.vocab, seed=5)
    max_len = S + GEN + 8
    jseq, _ = j_generate(
        jparams, jcfg, {"tokens": jnp.asarray(toks)},
        JC.zeros(JC.cache_spec(jcfg, B, max_len)), GEN)
    tseq, _ = tengine.greedy_generate(
        model, tcfg, {"tokens": torch.as_tensor(toks)},
        TC.zeros(TC.cache_spec(tcfg, B, max_len, dtype=torch.float32),
                 device="cpu"), GEN)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_decode_bf16_within_reference_bound(arch):
    jcfg, jparams, tcfg, model = _pair(arch, "bfloat16")
    toks = _tokens(jcfg.vocab, seed=3)
    jtok, ttok = jnp.asarray(toks), torch.as_tensor(toks)
    jcache = JC.zeros(JC.cache_spec(jcfg, B, S + 8))
    tcache = TC.zeros(TC.cache_spec(tcfg, B, S + 8), device="cpu")
    lj, jcache = j_prefill(jparams, jcfg, {"tokens": jtok[:, :-1]}, jcache)
    lt, tcache = tengine.prefill(model, tcfg, {"tokens": ttok[:, :-1]},
                                 tcache)
    assert _rel(lt, lj) < 3e-2
    dj, _ = j_decode(jparams, jcfg, jtok[:, -1:],
                     jnp.asarray(S - 1, jnp.int32), jcache)
    dt, _ = tengine.decode_step(model, tcfg, ttok[:, -1:], S - 1, tcache)
    assert _rel(dt, dj) < 3e-2


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_cache_bytes_against_max_len(arch):
    """xlstm's state is O(1): its cache bytes do not grow with max_len;
    hymba's attention K/V do."""
    cfg = tconfigs.get(arch)
    nbytes = [TC.cache_bytes(TC.cache_spec(cfg, 8, n))
              for n in (1064, 2 * 1064)]
    assert (nbytes[0] == nbytes[1]) == (arch == "xlstm-1.3b")


@pytest.mark.parametrize("arch", ENCDEC)
def test_encdec_and_vlm_build_on_meta(arch):
    """whisper's encoder groups and final norm, its decoder blocks'
    cross-attention leaves, and internvl2's plain decoder, built on meta
    at full and smoke size."""
    for cfg in (tconfigs.get(arch), tconfigs.get_smoke(arch)):
        model = TM.init_model(cfg, device="meta")
        blk = model.groups[0][0]["b0"]
        if cfg.is_encoder_decoder:
            assert len(model.enc_groups[0]) == cfg.encoder_layers
            assert model["enc_final_norm"].shape == (cfg.d_model,)
            assert blk["x_wk"].shape == (cfg.d_model,
                                         cfg.n_kv_heads * cfg.head_dim)
            assert blk["ln_x"].dtype == torch.float32
        else:
            assert len(model.enc_groups) == 0 and not hasattr(blk, "x_wq")


def test_serve_cli_moe_smoke_on_cpu(capsys):
    """``python -m repro_torch.launch.serve`` on olmoe's smoke config on
    the CPU: the generated ids and one placement line per service."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "olmoe-1b-7b", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    ids = lines[0].split(":", 1)
    assert ids[0] == "generated token ids (first row)"
    assert len(json.loads(ids[1])) == 4
    assert "tok/s on CPU" in lines[1]
    placed = [json.loads(ln) for ln in lines[2:]]
    assert len(placed) == 1 and placed[0]["service"] == "olmoe-1b-7b"
    assert len(placed[0]["nodes"]) == 5 and placed[0]["power_w"] > 0


@pytest.mark.parametrize("arch", RECURRENT + ENCDEC)
def test_serve_cli_recurrent_smoke_on_cpu(arch, capsys):
    """The serving CLI on the recurrent and the encoder-decoder / VLM
    smoke configs on the CPU (whisper's frames and internvl2's patches
    drawn after the tokens)."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                       "--gen", "4", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(json.loads(lines[0].split(":", 1)[1])) == 4
    assert "tok/s on CPU" in lines[1]
    placed = [json.loads(ln) for ln in lines[2:]]
    assert len(placed) == 1 and placed[0]["service"] == arch
    assert len(placed[0]["nodes"]) == 5 and placed[0]["power_w"] > 0


def test_layer_plan_and_registry_match_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in tconfigs.ARCH_IDS:
        assert dataclasses.asdict(tconfigs.get(arch)) == \
            dataclasses.asdict(jconfigs.get(arch))
        assert dataclasses.asdict(tconfigs.get_smoke(arch)) == \
            dataclasses.asdict(jconfigs.get_smoke(arch))
        plan = lambda M, c: [(g.kinds, g.repeats) for g in M.layer_plan(c)]
        assert plan(TM, tconfigs.get(arch)) == plan(JM, jconfigs.get(arch))
