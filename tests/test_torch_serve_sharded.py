"""The port's sharded serving (``serve/engine.py``, ``models/layers.py``)
against the JAX package's engine and the port's single-device engine: one
4-rank gloo job (``tests/_torch_dist.py``) on a ("data", "model") (2, 2)
mesh serves a float32 smoke model of each cache family at 2 layers and B
4 -- its weights the reference's (``params_from_numpy``), each rank its
batch block and its blocks of the cache -- through prefill and greedy
decode steps:
  * qwen3-4b (dense GQA; its cache of 28 slots split along kv_seq);
  * gemma2-27b (an 88-token prompt past its local layer's 64-slot ring,
    which the model axis splits; its global cache of 93 slots, which it
    does not divide, whole on every rank);
  * deepseek-v2-236b (MLA: the absorbed decode over each rank's block of
    the compressed KV; its MoE layer at the config's capacity factor,
    below the expert-parallel threshold, where the capacity counts the
    whole batch's tokens and a token queues behind every rank's earlier
    ones, as in the reference's sort path);
  * hymba-1.5b (its attention cache split, its mamba state whole on the
    model ranks);
  * whisper-base (its cross cache of 32 encoder slots split);
  * hymba-1.5b with 3 heads (``n_heads=3``), which the model axis does not
    divide: its prefill takes the reference's fallback to sequence
    parallelism (each model rank attends half the query rows).
Every cell runs tensor-parallel over the model axis: each model rank
computes half the heads (or of the query rows), half the ffn columns
and half the vocabulary, from the blocks of the leaves the model axis
splits, which are never all-gathered along it.
Then the cache layout: every leaf's logical axes, and their spec on a
16 x 16 mesh, equal to the reference's for every architecture.

Tolerances: against the reference's logits rtol 1e-4 / atol 2e-4 (the
bound of tests/test_torch_models.py: the same arithmetic summed in
another order) and greedy ids equal; against the port's single-device
engine logits within 1e-5 of the largest logit, and each rank's cache
blocks within 1e-5 of the single-device cache's (positions equal)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.parallel import sharding as jsh
from repro.serve import cache as JC, engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as sh
from repro_torch.serve import cache as TC, engine as tengine

from _torch_dist import run_ranks, sharded_serving

B, STEPS = 4, 4
SIZES = {"data": 2, "model": 2}
# cell -> (arch, prompt tokens, cache slots, encoder frames, config
# overrides)
CELLS = {
    "qwen3-4b": ("qwen3-4b", 20, 28, 0, {}),
    "gemma2-27b": ("gemma2-27b", 88, 93, 0, {}),
    "deepseek-v2-236b": ("deepseek-v2-236b", 20, 28, 0, {}),
    "hymba-1.5b": ("hymba-1.5b", 24, 32, 0, {}),
    "whisper-base": ("whisper-base", 12, 20, 32, {}),
    "hymba-1.5b-3-heads": ("hymba-1.5b", 24, 32, 0, {"n_heads": 3}),
}
j_prefill = jax.jit(jengine.prefill, static_argnums=1)
j_decode = jax.jit(jengine.decode_step, static_argnums=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(arch: str, overrides: dict):
    kw = dict(n_layers=2, dtype="float32", **overrides)
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


def _noisy(tree, rng):
    """The reference's tree as numpy, norm scales random (the init's zeros
    would hide a wrong ``1 + scale``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _noisy(v, rng)
        elif "norm" in k or k in ("ln1", "ln2", "ln_x"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _reference(jcfg, tree, batch, max_len, enc_len):
    """The reference engine's greedy run: logits of the prefill and of
    each decode step."""
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    cache = JC.zeros(JC.cache_spec(jcfg, B, max_len, enc_len=enc_len,
                                   dtype=jnp.float32))
    logits, cache = j_prefill(jparams, jcfg,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              cache)
    steps = [np.asarray(logits)]
    prompt = batch["tokens"].shape[1]
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        logits, cache = j_decode(jparams, jcfg, tok,
                                 jnp.asarray(prompt + i, jnp.int32), cache)
        steps.append(np.asarray(logits))
    return steps


def _single(tcfg, tree, batch, max_len, enc_len):
    """The port's single-device engine, the same run: logits and cache."""
    model = TM.params_from_numpy(tcfg, tree, device="cpu")
    cache = TC.zeros(TC.cache_spec(tcfg, B, max_len, enc_len=enc_len,
                                   dtype=torch.float32), "cpu")
    logits, cache = tengine.prefill(
        model, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()},
        cache)
    steps = [logits.numpy()]
    prompt = batch["tokens"].shape[1]
    for i in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        logits, cache = tengine.decode_step(model, tcfg, tok, prompt + i,
                                            cache)
        steps.append(logits.numpy())
    return steps, [t.numpy() for t in TC.leaves(cache)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The 4-rank job and both single-device runs of every cell."""
    cells, want = [], {}
    for i, (name, (arch, prompt, max_len, enc_len, over)) in enumerate(
            CELLS.items()):
        jcfg, tcfg = _configs(arch, over)
        params, _ = JM.init_model(jcfg, jax.random.PRNGKey(1))
        tree = _noisy(params, np.random.default_rng(2))
        rng = np.random.default_rng(10 + i)
        batch = {"tokens": rng.integers(0, jcfg.vocab, (B, prompt))
                 .astype(np.int32)}
        if enc_len:
            batch["frames"] = (0.1 * rng.standard_normal(
                (B, enc_len, jcfg.d_model))).astype(np.float32)
        cells.append(dict(name=name, arch=arch, tree=tree, batch=batch,
                          max_len=max_len, enc_len=enc_len, steps=STEPS,
                          overrides=dict(n_layers=2, dtype="float32",
                                         **over)))
        single, cache = _single(tcfg, tree, batch, max_len, enc_len)
        want[name] = dict(reference=_reference(jcfg, tree, batch, max_len,
                                               enc_len),
                          single=single, cache=cache, tcfg=tcfg)
    ranks = run_ranks(sharded_serving, 4, tmp_path_factory.mktemp("serve"),
                      cells)
    return ranks, want


def _rows(ranks, arch, key, step=None):
    """A rank-assembled [B, ...] array: the data ranks' rows in order (the
    model ranks of one data coordinate hold the same rows)."""
    parts = {}
    for r in ranks:
        got = r[arch][key]
        parts[r["coordinate"]["data"]] = got if step is None else got[step]
    return np.concatenate([parts[d] for d in sorted(parts)])


@pytest.mark.parametrize("arch", list(CELLS))
def test_sharded_serving_matches_reference_and_single_device(served, arch):
    """Every step's logits against the reference's (rtol 1e-4 / atol
    2e-4) and the single-device engine's (1e-5 of the largest); greedy ids
    equal; the model ranks of a data coordinate agree exactly."""
    ranks, want = served
    ref, single = want[arch]["reference"], want[arch]["single"]
    for s in range(STEPS + 1):
        got = _rows(ranks, arch, "logits", s)
        np.testing.assert_allclose(got, ref[s], rtol=1e-4, atol=2e-4)
        scale = np.abs(single[s]).max()
        assert np.abs(got - single[s]).max() <= 1e-5 * scale, (arch, s)
    ids = _rows(ranks, arch, "ids")
    np.testing.assert_array_equal(
        ids, np.stack([r.argmax(-1) for r in ref], 1))
    by_data = {}
    for r in ranks:
        d = r["coordinate"]["data"]
        if d in by_data:
            for a, b in zip(r[arch]["logits"], by_data[d]):
                np.testing.assert_array_equal(a, b)
        by_data[d] = r[arch]["logits"]


@pytest.mark.parametrize("arch", list(CELLS))
def test_each_rank_holds_its_blocks_of_the_cache(served, arch):
    """Each rank's cache leaves are its blocks of the single-device cache
    (``held_spec``: batch over "data", kv_seq over "model" where 2
    divides, the recurrent states' heads / tp whole), within 1e-5 of each
    leaf's largest magnitude, positions equal; at least one leaf split
    along kv_seq."""
    ranks, want = served
    tcfg = want[arch]["tcfg"]
    _, prompt, max_len, enc_len, _ = CELLS[arch]
    spec = TC.leaves(TC.cache_spec(tcfg, B, max_len, enc_len=enc_len,
                                   dtype=torch.float32))
    split_kv = 0
    for r in ranks:
        for s, whole, got in zip(spec, want[arch]["cache"], r[arch]["cache"]):
            held = TC.held_spec(s, SIZES)
            blk = sh.block(held, s.shape, SIZES, r["coordinate"])
            assert got.shape == whole[blk].shape
            if s.dtype == torch.int32:
                np.testing.assert_array_equal(got, whole[blk])
            else:
                np.testing.assert_allclose(
                    got, whole[blk], rtol=0,
                    atol=1e-5 * max(np.abs(whole).max(), 1e-30))
            split_kv += "kv_seq" in s.axes and held[s.axes.index(
                "kv_seq")] is not None
    assert split_kv > 0


@pytest.mark.parametrize("arch", list(CELLS))
def test_each_model_rank_computes_its_share(served, arch):
    """Tensor-parallel compute on the model axis of 2: at prefill a rank's
    attention takes H / 2 query heads, or -- where 2 does not divide the
    heads (the fallback cell) -- all H heads on S / 2 query rows; MLA
    takes every head (its split is not ported); a decode step over a
    cache split along kv_seq attends every query head on the rank's half
    of the slots, over a whole cache H / 2 heads; every dense MLP's
    hidden width is d_ff / 2; no leaf the model axis splits for the
    compute (``models.model.tp_leaves``) is all-gathered along it, and a
    leaf whose split does not fall on whole heads (qwen's single kv
    head's wk) is; no rank's block keeps a larger storage alive."""
    ranks, want = served
    tcfg = want[arch]["tcfg"]
    _, prompt, max_len, enc_len, _ = CELLS[arch]
    H, Dh = tcfg.n_heads, tcfg.head_dim
    ff = TM._dense_ff(tcfg)
    for r in ranks:
        got = r[arch]
        prefill = [c for c in got["attend"] if c[0] == 0]
        decode = [c for c in got["attend"] if c[0] > 0]
        assert prefill and (decode or tcfg.use_mla)
        for _, fn, q, k in prefill:
            if tcfg.use_mla:
                assert q[2] == H
            elif H % 2:
                assert q[1] == prompt // 2 and q[2] == H, (q, k)
            else:
                assert q[2] == H // 2 and q[3] == Dh, (q, k)
        for _, fn, q, k in decode:
            assert q[1] == 1
            if fn == "attend_lse":
                assert q[2] == H and k[1] < max(max_len, enc_len), (q, k)
            else:
                assert q[2] == (H if H % 2 else H // 2), (q, k)
        widths = {w for _, prefix, w in got["mlp"] if prefix == ""}
        assert widths == {ff // 2}, widths
        split = set(got["tp_leaves"])
        assert split and not split & set(got["gathered_along_model"])
        # a rank's block owns its storage (a row block of the whole leaf
        # would keep all of it alive)
        assert got["pinned_storage"] == []
        assert ("top.embed" in split) == (tcfg.vocab % 2 == 0)
    if arch == "qwen3-4b":
        assert "groups.0.0.b0.wq" in split
        assert "groups.0.0.b0.wk" in ranks[0][arch]["gathered_along_model"]
    if H % 2:
        assert not any(n.endswith(".attn_wq") for n in split)


def test_gemma2_global_cache_stays_whole_and_local_ring_splits():
    """The 93-slot global cache is whole on every model rank (2 does not
    divide it), the 64-slot local ring split in two blocks of 32."""
    _, tcfg = _configs("gemma2-27b", {})
    cache = TC.zeros(TC.cache_spec(tcfg, B, 93, dtype=torch.float32), "cpu",
                     mesh=SIZES)
    local, glob = cache[0]["b0"], cache[0]["b1"]
    assert tuple(local["k"].shape[1:3]) == (B // 2, 32)
    assert tuple(glob["k"].shape[1:3]) == (B // 2, 93)
    assert local["pos_ids"].shape[-1] == 64 and glob["pos_ids"].shape[-1] == 93


def _spec_leaves(spec, tree) -> list:
    """The leaves of ``tree`` (a spec tree mapped leaf for leaf) at the
    places of ``spec``'s ``TSpec`` leaves, in the reference's order (dict
    keys sorted): a spec tuple is a leaf there, not a container."""
    if isinstance(spec, TC.TSpec):
        return [tree]
    if isinstance(spec, dict):
        return [x for k in sorted(spec) for x in _spec_leaves(spec[k],
                                                              tree[k])]
    return [x for s, t in zip(spec, tree) for x in _spec_leaves(s, t)]


@pytest.mark.parametrize("smoke", (True, False), ids=("smoke", "full"))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cache_axes_and_specs_match_reference(arch, smoke):
    """Every cache leaf's logical axes equal the reference's ``TSpec.axes``
    (the stacked repeats axis None), and its spec on a 16 x 16 mesh (the
    reference's ``logical_spec`` through a stand-in holding the sizes)
    the reference's ``shardings``; ``sds`` gives meta tensors of the whole
    shapes."""
    get_j = jconfigs.get_smoke if smoke else jconfigs.get
    get_t = tconfigs.get_smoke if smoke else tconfigs.get
    jcfg, tcfg = get_j(arch), get_t(arch)
    enc = 64 if jcfg.is_encoder_decoder else 0
    jspec = JC.cache_spec(jcfg, 32, 1024, enc_len=enc)
    tspec = TC.cache_spec(tcfg, 32, 1024, enc_len=enc)
    jl = jax.tree_util.tree_leaves(jspec, is_leaf=lambda x: isinstance(
        x, JC.TSpec))
    tl = TC.leaves(tspec)
    assert [s.axes for s in tl] == [s.axes for s in jl]
    assert [s.shape for s in tl] == [tuple(s.shape) for s in jl]
    sizes = {"data": 16, "model": 16}
    stand_in = types.SimpleNamespace(shape=sizes)
    got = _spec_leaves(tspec, TC.shardings(tspec, sizes))
    want = [tuple(jsh.logical_spec(s.axes, s.shape, stand_in)) for s in jl]
    assert got == want
    metas = TC.leaves(TC.sds(tspec))
    assert all(m.is_meta and tuple(m.shape) == s.shape and m.dtype == s.dtype
               for m, s in zip(metas, tl))


def test_one_rank_mesh_reads_every_leaf_in_place():
    """On a (1, 1) mesh (one gloo process) ``shard_model`` keeps every
    leaf's storage and the served view reads each leaf in place: no axis
    of one rank splits a leaf, so nothing is gathered or copied."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cpu")
    try:
        _, tcfg = _configs("qwen3-4b", {})
        model = TM.init_model(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
        ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
        tengine.shard_model(model, mesh)
        with sh.mesh_context(mesh):
            view = tengine._params(model)
            assert view["embed"].data_ptr() == ptrs["top.embed"]
            for r, unit in enumerate(view.groups[0]):
                blk = unit["b0"]
                for name in ("wq", "wk", "w_down", "ln1"):
                    assert blk[name].data_ptr() == \
                        ptrs[f"groups.0.{r}.b0.{name}"]
    finally:
        dist.destroy_process_group()


def test_cross_cache_kept_whole_decodes_without_combine():
    """whisper's cross cache of 33 encoder slots, which a model axis of 2
    does not divide, is whole on the rank: its decode reads the encoder
    length the step records and attends the cache with no combine (on a
    mesh of sizes, which has no process group, a combine would raise),
    equal to the single-device call; without the recorded length the call
    raises."""
    _, tcfg = _configs("whisper-base", {})
    model = TM.init_model(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    blk = model.groups[0][0]["b0"]
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 1, tcfg.d_model), generator=g)
    enc_out = torch.randn((2, 33, tcfg.d_model), generator=g)
    kv = (2, 33, tcfg.n_kv_heads, tcfg.head_dim)
    cache = {"k": torch.zeros(kv), "v": torch.zeros(kv)}
    TM.cross_attention(blk, x, tcfg, enc_out=enc_out, cache=cache)
    want = TM.cross_attention(blk, x, tcfg, enc_out=None, cache=cache)
    with sh.mesh_context({"data": 1, "model": 2}):
        with sh.step_facts({"enc_len": 33}):
            got = TM.cross_attention(blk, x, tcfg, enc_out=None, cache=cache)
        with pytest.raises(ValueError, match="encoder length"):
            TM.cross_attention(blk, x, tcfg, enc_out=None, cache=cache)
    assert torch.equal(got, want)


def test_moe_on_a_split_batch_needs_the_whole_batch():
    """An MoE layer under a mesh that splits the batch raises without the
    whole batch a serving step records, and with it raises on rows that
    are not the rank's block."""
    from repro_torch.models import layers as TL
    _, tcfg = _configs("deepseek-v2-236b", {})
    model = TM.init_model(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    blk = next(b for units in model.groups for u in units for b in u.values()
               if "router" in dict(b.named_parameters()))
    x = torch.zeros((2, 3, tcfg.d_model))
    with sh.mesh_context({"data": 2, "model": 1}):
        with pytest.raises(ValueError, match="whole batch"):
            TL.moe(blk, x, tcfg)
        with sh.step_facts({"batch": 8}), \
                pytest.raises(ValueError, match="rank's block"):
            TL.moe(blk, x, tcfg)
