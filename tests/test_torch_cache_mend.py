"""The KV cache's ring write (``models/layers.py::_write_cache``) against
the JAX package's, for a call longer than the ring (S > Smax).

The reference scatters every position of the call with ``.at[:,
slots].set``, which keeps each slot's last write.  An ``index_put_`` of all
S positions writes a slot several times in one call, and neither the CPU's
thread pool nor CUDA fixes which write stays; the port writes only the
call's last Smax positions, each slot once, which is the reference's
result.  Held here: the write alone, byte-equal to the reference's on the
same numpy inputs in 20 of 20 runs under 8 threads (and on the card), and
a prefill past the smoke ring of the three windowed configurations
(gemma2-27b, h2o-danube-3-4b, hymba-1.5b) against the reference's engine:
positions byte-equal, every other cache leaf and the logits within rtol
1e-4 / atol 2e-4 (tests/test_torch_models.py's float32 bound)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers, model as JM
from repro.serve import cache as JC, engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers, model as TM
from repro_torch.serve import cache as TC, engine as tengine

B, KH, D, SMAX, S = 4, 4, 64, 64, 88
REPEATS, THREADS = 20, 8
j_prefill = jax.jit(jengine.prefill, static_argnums=1)


def _inputs():
    r = np.random.default_rng(5)
    k = r.standard_normal((B, S, KH, D), dtype=np.float32)
    v = r.standard_normal((B, S, KH, D), dtype=np.float32)
    return k, v, np.arange(S, dtype=np.int32)


def _reference_write(k, v, pos):
    """The reference attention's cache write: ``_scatter_kv`` on K and V,
    ``.at[slots].set`` on the positions -- on the CPU backend, whose
    scatter keeps a slot's last write (a GPU backend's keeps any)."""
    with jax.default_device(jax.devices("cpu")[0]):
        zeros = jnp.zeros((B, SMAX, KH, D), jnp.float32)
        slots = jnp.asarray(pos) % SMAX
        return (np.asarray(jlayers._scatter_kv(zeros, jnp.asarray(k),
                                               slots)),
                np.asarray(jlayers._scatter_kv(zeros, jnp.asarray(v),
                                               slots)),
                np.asarray(jnp.full((SMAX,), -1, jnp.int32).at[slots].set(
                    jnp.asarray(pos))))


def _port_write(k, v, pos, device):
    cache = dict(k=torch.zeros((B, SMAX, KH, D), device=device),
                 v=torch.zeros((B, SMAX, KH, D), device=device),
                 pos_ids=torch.full((SMAX,), -1, dtype=torch.int32,
                                    device=device))
    t = lambda a: torch.as_tensor(a, device=device)
    tlayers._write_cache(cache, t(pos), torch.float32, k=t(k), v=t(v))
    return [cache[n].cpu().numpy() for n in ("k", "v", "pos_ids")]


def test_write_past_the_ring_byte_equal_to_reference_under_8_threads():
    k, v, pos = _inputs()
    want = _reference_write(k, v, pos)
    # the ring keeps the last SMAX positions
    np.testing.assert_array_equal(want[2], np.concatenate(
        [np.arange(SMAX, S), np.arange(S - SMAX, SMAX)]))
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        for _ in range(REPEATS):
            for got, ref in zip(_port_write(k, v, pos, "cpu"), want):
                assert got.tobytes() == ref.tobytes()
    finally:
        torch.set_num_threads(prev)


@pytest.mark.gpu
def test_write_past_the_ring_byte_equal_to_reference_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k, v, pos = _inputs()
    want = _reference_write(k, v, pos)
    for _ in range(REPEATS):
        for got, ref in zip(_port_write(k, v, pos, "cuda"), want):
            assert got.tobytes() == ref.tobytes()


def _noisy(tree, rng):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _noisy(val, rng)
        elif "norm" in key or key in ("ln1", "ln2"):
            out[key] = (0.1 * rng.standard_normal(val.shape)).astype(
                np.float32)
        else:
            out[key] = np.asarray(val)
    return out


@pytest.mark.parametrize("arch", ("gemma2-27b", "h2o-danube-3-4b",
                                  "hymba-1.5b"))
def test_prefill_past_the_ring_matches_reference(arch):
    """An 88-token prefill into a cache of 96 slots, whose windowed layers
    hold a 64-slot ring: every cache leaf and the last logits against the
    reference's engine (module docstring)."""
    kw = dict(n_layers=2, dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(1))
    tree = _noisy(params, np.random.default_rng(2))
    model = TM.params_from_numpy(tcfg, tree, device="cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, S)) \
        .astype(np.int32)
    max_len = S + 8
    jcache = JC.zeros(JC.cache_spec(jcfg, 2, max_len, dtype=jnp.float32))
    tcache = TC.zeros(TC.cache_spec(tcfg, 2, max_len, dtype=torch.float32),
                      "cpu")
    rings = [t for t in TC.leaves(tcache) if t.dtype == torch.int32
             and t.shape[-1] == SMAX]
    assert rings, f"{arch}: no {SMAX}-slot ring in the cache"
    lj, jcache = j_prefill(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                           {"tokens": jnp.asarray(toks)}, jcache)
    lt, tcache = tengine.prefill(model, tcfg,
                                 {"tokens": torch.as_tensor(toks)}, tcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=2e-4)
    jl = jax.tree_util.tree_leaves(jcache)
    tl = TC.leaves(tcache)
    assert len(tl) == len(jl)
    for got, want in zip(tl, jl):
        want = np.asarray(want)
        if got.dtype == torch.int32:
            assert got.numpy().tobytes() == want.tobytes()
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=2e-4)
    for ring in rings:
        assert int(ring.min()) == S - SMAX and int(ring.max()) == S - 1
