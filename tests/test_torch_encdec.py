"""whisper-base's encoder-decoder (the encoder, cross-attention and its
cross cache) and internvl2-2b's patch prefix in the PyTorch port against
the JAX package: the smoke configurations with the JAX weights carried
across (``params_from_numpy``), inputs built as the reference's
``tests/test_models.py::_batch`` builds them (frames and patches 0.1 x
normal, then the tokens, from one numpy generator).

Tolerances: float32 hidden states and logits rtol 1e-4 / atol 1e-4 (the
same arithmetic, summed in another order), every cache leaf the same;
greedy ids equal; bfloat16 logits within 3e-2 of the largest logit (the
reference's own bound for cached decode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import cache as JC
from repro_torch.models import model as TM
from repro_torch.serve import cache as TC, engine as tengine
from test_torch_models import (ENCDEC, _np, _pair, _rel, j_decode, j_forward,
                               j_generate, j_prefill)

B, S, GEN = 2, 17, 8


def _batch(cfg, seed: int = 7) -> dict:
    """numpy inputs as the reference's test ``_batch``: frames [B, S, D]
    (the encoder's length is S) or patches [B, P, D], then S - P tokens."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = (0.1 * rng.standard_normal((B, S, cfg.d_model))) \
            .astype(np.float32)
    if cfg.vision_prefix_tokens:
        out["patches"] = (0.1 * rng.standard_normal(
            (B, cfg.vision_prefix_tokens, cfg.d_model))).astype(np.float32)
    text = S - (cfg.vision_prefix_tokens or 0)
    out["tokens"] = rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)
    return out


def _both(batch: dict, **cut) -> tuple:
    """The batch as JAX and as torch arrays; ``cut`` slices some keys."""
    b = {k: v[tuple(cut[k])] if k in cut else v for k, v in batch.items()}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _caches(jcfg, tcfg, max_len: int, jdtype, tdtype):
    enc_len = S if jcfg.is_encoder_decoder else 0
    return (JC.zeros(JC.cache_spec(jcfg, B, max_len, enc_len=enc_len,
                                   dtype=jdtype)),
            TC.zeros(TC.cache_spec(tcfg, B, max_len, enc_len=enc_len,
                                   dtype=tdtype), device="cpu"))


def _leaves_equal(tcache, jcache) -> None:
    jl = jax.tree_util.tree_leaves(jcache)
    tl = TC.leaves(tcache)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=ENCDEC)
def encdec_f32(request):
    return _pair(request.param, "float32")


def test_encdec_params_from_numpy_layout(encdec_f32):
    """The encoder's ``enc_g0`` leaves and ``enc_final_norm`` carried
    across (repeat r to the r-th module), the decoder's cross-attention
    leaves beside them; parameter counts equal."""
    jcfg, jparams, tcfg, model = encdec_f32
    assert TM.param_count(model) == sum(
        x.size for x in jax.tree_util.tree_leaves(jparams))
    if not tcfg.is_encoder_decoder:
        assert "enc_g0" not in jparams and len(model.enc_groups) == 0
        return
    enc = model.enc_groups[0][1]["b0"]
    np.testing.assert_array_equal(
        enc["wq"].numpy(), np.asarray(jparams["enc_g0"]["b0"]["wq"][1]))
    np.testing.assert_array_equal(model["enc_final_norm"].numpy(),
                                  np.asarray(jparams["enc_final_norm"]))
    dec = model.groups[0][1]["b0"]
    for leaf in ("x_wv", "ln_x"):
        np.testing.assert_array_equal(
            dec[leaf].numpy(), np.asarray(jparams["g0"]["b0"][leaf][1]))
    assert len(model.enc_groups[0]) == tcfg.encoder_layers


def test_encdec_forward_prefill_decode_match_f32(encdec_f32):
    """forward_hidden ([B, P + S, D] for internvl2), prefill logits and
    every self- and cross-cache leaf after prefill, one decode step's
    logits and every leaf after it; the cached decode against the port's
    own forward's last logits."""
    jcfg, jparams, tcfg, model = encdec_f32
    batch = _batch(jcfg)
    jb, tb = _both(batch)
    h_j = j_forward(jparams, jcfg, jb)
    h_t = TM.forward_hidden(model, tcfg, tb)
    P = jcfg.vision_prefix_tokens or 0
    assert tuple(h_t.shape) == (B, S, jcfg.d_model)
    assert tuple(h_t.shape) == (B, P + batch["tokens"].shape[1],
                                jcfg.d_model)
    np.testing.assert_allclose(_np(h_t), _np(h_j), rtol=1e-4, atol=1e-4)

    jcache, tcache = _caches(jcfg, tcfg, S + 8, jnp.float32, torch.float32)
    jp, tp = _both(batch, tokens=(slice(None), slice(None, -1)))
    lj, jcache = j_prefill(jparams, jcfg, jp, jcache)
    lt, tcache = tengine.prefill(model, tcfg, tp, tcache)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-4, atol=1e-4)
    _leaves_equal(tcache, jcache)
    last = batch["tokens"][:, -1:]
    dj, jcache = j_decode(jparams, jcfg, jnp.asarray(last),
                          jnp.asarray(S - 1, jnp.int32), jcache)
    dt, tcache = tengine.decode_step(model, tcfg, torch.as_tensor(last),
                                     S - 1, tcache)
    np.testing.assert_allclose(_np(dt), _np(dj), rtol=1e-4, atol=1e-4)
    _leaves_equal(tcache, jcache)
    ref = TM.logits_fn(model, tcfg, h_t[:, -1:])[:, 0]
    np.testing.assert_allclose(_np(dt), _np(ref), rtol=1e-4, atol=1e-4)


def test_encdec_greedy_generate_ids_equal_f32(encdec_f32):
    """Greedy ids over GEN steps equal the reference's (internvl2's
    decoding starts after its patch prefix), and the cache after them."""
    jcfg, jparams, tcfg, model = encdec_f32
    jb, tb = _both(_batch(jcfg, seed=5))
    jcache, tcache = _caches(jcfg, tcfg, S + GEN + 8, jnp.float32,
                             torch.float32)
    jseq, jcache = j_generate(jparams, jcfg, jb, jcache, GEN)
    tseq, tcache = tengine.greedy_generate(model, tcfg, tb, tcache, GEN)
    assert tseq.dtype == torch.int32 and tuple(tseq.shape) == (B, GEN)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    _leaves_equal(tcache, jcache)


def test_cross_cache_written_once_at_prefill():
    """whisper's cross cache holds the encoder's projected K/V after
    prefill and decode steps leave its bytes as they were; with neither
    ``enc_out`` nor a cache, cross-attention raises."""
    jcfg, _, tcfg, model = _pair("whisper-base", "float32")
    _, tb = _both(_batch(jcfg))
    _, tcache = _caches(jcfg, tcfg, S + 8, jnp.float32, torch.float32)
    logits, tcache = tengine.prefill(model, tcfg, tb, tcache)
    cross = [c.clone() for g in tcache for c in TC.leaves(g["b0"]["cross"])]
    assert all(float(c.abs().max()) > 0 for c in cross)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    for i in range(3):
        logits, tcache = tengine.decode_step(model, tcfg, tok, S + i, tcache)
    after = [c for g in tcache for c in TC.leaves(g["b0"]["cross"])]
    assert all(torch.equal(a, b) for a, b in zip(after, cross))
    blk = model.groups[0][0]["b0"]
    with pytest.raises(ValueError, match="enc_out or a cache"):
        TM.cross_attention(blk, torch.zeros(B, 1, tcfg.d_model), tcfg,
                           enc_out=None, cache=None)


@pytest.mark.parametrize("arch", ENCDEC)
def test_encdec_prefill_decode_bf16_within_reference_bound(arch):
    jcfg, jparams, tcfg, model = _pair(arch, "bfloat16")
    batch = _batch(jcfg, seed=3)
    jcache, tcache = _caches(jcfg, tcfg, S + 8, jnp.bfloat16, torch.bfloat16)
    jp, tp = _both(batch, tokens=(slice(None), slice(None, -1)))
    lj, jcache = j_prefill(jparams, jcfg, jp, jcache)
    lt, tcache = tengine.prefill(model, tcfg, tp, tcache)
    assert lt.dtype == torch.float32
    assert _rel(lt, lj) < 3e-2
    last = batch["tokens"][:, -1:]
    dj, _ = j_decode(jparams, jcfg, jnp.asarray(last),
                     jnp.asarray(S - 1, jnp.int32), jcache)
    dt, _ = tengine.decode_step(model, tcfg, torch.as_tensor(last), S - 1,
                                tcache)
    assert _rel(dt, dj) < 3e-2
