"""Training slice of the PyTorch port against the JAX package: the
differentiable attention (``kernels.flash_attention.attend``: the kernel's
forward, the reference's chunked flash backward) against ``jax.vjp`` of the
reference's ``attend``; the chunked loss; the synthetic data stream; AdamW
and its weight-decay rule; one train step on qwen3-4b's smoke configuration
with the JAX weights carried across as float32 masters
(``params_from_numpy(..., trainable=True)``); the loss falling; the train
CLI; the import guard.

Tolerances: attention gradients rtol 1e-4 with atol 1e-5 of each tensor's
largest magnitude (float32, summed in another order); the loss rtol 1e-5;
the data byte-equal; AdamW parameters and moments rtol 1e-5; one float32
step's loss rtol 1e-5 and every parameter within 1e-4 of its leaf's
largest magnitude (AdamW's first update is g / (|g| + eps): gradients near
eps turn float32 rounding into relative differences up to ~5e-4 at single
elements); a bf16 step's loss within 2e-2 relative (XLA on
the CPU may keep bf16 products unrounded)."""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jdata
from repro.models import layers as jlayers, model as JM
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import flash_attention as tfa, ops as tops
from repro_torch.launch import train as train_cli
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the training tests run
    many small operations forward and backward, and under several test
    workers a thread pool per process oversubscribes the cores (a
    step's backward then waits on spinning pools)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ATTN_CASES = [
    # B, H, KH, Sq, Skv, D, causal, window, cap, q_start, dead kv slots
    (2, 4, 2, 64, 64, 32, True, None, None, 0, 0),       # causal GQA
    (1, 4, 4, 48, 80, 16, False, None, None, 0, 0),      # non-causal
    (1, 8, 2, 40, 600, 16, True, 64, 30.0, 560, 5),      # 2 chunks, window
    (2, 4, 1, 20, 100, 32, True, None, None, -6, 3),     # fully masked rows
    (2, 4, 4, 3, 100, 32, True, None, 5.0, 97, 2),       # decode-sized q
]


def _attn_inputs(B, H, KH, Sq, Skv, D, q_start, dead, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = r.standard_normal((B, Skv, KH, D)).astype(np.float32)
    v = r.standard_normal((B, Skv, KH, D)).astype(np.float32)
    do = r.standard_normal((B, Sq, H, D)).astype(np.float32)
    qp = np.arange(q_start, q_start + Sq, dtype=np.int32)
    kp = np.arange(Skv, dtype=np.int32)
    kp[:dead] = -1
    return q, k, v, do, qp, kp


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"a{i}" for i in range(len(ATTN_CASES))])
def test_attend_gradients_match_jax_vjp(case):
    B, H, KH, Sq, Skv, D, causal, window, cap, q_start, dead = case
    q, k, v, do, qp, kp = _attn_inputs(B, H, KH, Sq, Skv, D, q_start, dead)

    def ref(q, k, v):
        return jlayers.attend(q, k, v, q_positions=jnp.asarray(qp),
                              kv_positions=jnp.asarray(kp), causal=causal,
                              window=window, logit_cap=cap)

    out_j, grads_j = jax.jit(lambda *a: (lambda o, f: (o, f(a[3])))(
        *jax.vjp(ref, *a[:3])))(q, k, v, do)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out_t = tfa.attend(tq, tk, tv, torch.tensor(qp), torch.tensor(kp),
                       causal=causal, window=window, logit_cap=cap)
    out_t.backward(torch.tensor(do))
    _close(out_t.detach().numpy(), out_j, 1e-4, 1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        assert torch.isfinite(got).all()
        _close(got.numpy(), want, 1e-4, 1e-5)
    if q_start < 0:          # rows before every kv position: zero, not NaN
        assert not tq.grad[:, :-q_start].any()


def test_attend_has_a_grad_fn_only_under_grad():
    q, k, v, _, qp, kp = _attn_inputs(1, 2, 1, 12, 12, 16, 0, 0)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    pos = (torch.tensor(qp), torch.tensor(kp))
    out = tfa.attend(tq, tk, tv, *pos)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    with torch.no_grad():
        assert tfa.attend(tq, tk, tv, *pos).grad_fn is None
    frozen = tfa.attend(tq.detach(), tk.detach(), tv.detach(), *pos)
    assert frozen.grad_fn is None
    torch.testing.assert_close(frozen, out.detach(), rtol=0, atol=0)


def test_ops_flash_attention_differentiates_as_attend():
    """The public wrapper in the TPU kernel's layout ([B, H, S, D]) has a
    grad_fn under grad, and its gradients are attend's."""
    q, k, v, do, qp, kp = _attn_inputs(2, 4, 2, 24, 24, 16, 0, 0, seed=3)
    leaves = [torch.tensor(a).transpose(1, 2).contiguous().requires_grad_()
              for a in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=True, window=8,
                               logit_cap=20.0)
    assert out.grad_fn is not None
    out.backward(torch.tensor(do).transpose(1, 2))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tfa.attend(tq, tk, tv, torch.tensor(qp), torch.tensor(kp), causal=True,
               window=8, logit_cap=20.0).backward(torch.tensor(do))
    for got, want in zip(leaves, (tq, tk, tv)):
        _close(got.grad.transpose(1, 2).numpy(), want.grad.numpy(), 1e-4,
               1e-5)


# ---------------------------------------------------------------------------
# loss, data
# ---------------------------------------------------------------------------

def to_tree(model, leaf=lambda p: p):
    """The reference's parameter tree of ``leaf(p)`` for each of the port's
    parameters (float32 numpy, each group's layers stacked along a leading
    ``repeats`` axis): the inverse of ``params_from_numpy``."""
    f32 = lambda p: leaf(p).detach().float().cpu().numpy()

    def stacked(stack, tag):
        return {f"{tag}{gi}": {b: {name: np.stack([f32(unit[b][name])
                                                   for unit in units])
                                   for name, _ in blk.named_parameters()}
                               for b, blk in units[0].items()}
                for gi, units in enumerate(stack)}

    return {**{name: f32(p) for name, p in model.top.named_parameters()},
            **stacked(model.groups, "g"), **stacked(model.enc_groups, "enc_g")}


@functools.lru_cache(maxsize=None)
def _f32_pair(arch: str, seed: int = 0):
    """(reference cfg, its float32 params, port cfg, the params as numpy):
    read only, so built once per (arch, seed)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, tcfg, jax.tree_util.tree_map(np.asarray, params)


def test_chunked_xent_matches_direct_and_reference():
    jcfg, params, tcfg, tree = _f32_pair("qwen3-4b")
    model = TM.params_from_numpy(tcfg, tree, device="cpu")
    r = np.random.default_rng(3)
    h = (0.5 * r.standard_normal((2, 32, tcfg.d_model))).astype(np.float32)
    labels = r.integers(0, tcfg.vocab, (2, 32)).astype(np.int32)
    want = float(jax.jit(JM.xent_loss, static_argnums=1)(
        params, jcfg, jnp.asarray(h), jnp.asarray(labels)))
    th, tl = torch.tensor(h), torch.tensor(labels)
    chunked = float(TM.xent_loss(model, tcfg, th, tl, n_chunks=8))
    direct = float(TM.xent_loss(model, tcfg, th, tl, n_chunks=1))
    odd = float(TM.xent_loss(model, tcfg, th, tl, n_chunks=7))  # -> 4
    for got in (chunked, direct, odd):
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-base",
                                  "internvl2-2b"])
def test_batches_and_iterator_byte_equal(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jd = jdata.DataConfig(seed=3, batch=4, seq_len=48)
    td = tdata.DataConfig(seed=3, batch=4, seq_len=48)
    for step in (0, 5):
        want, got = jdata.make_batch(jcfg, jd, step), \
            tdata.make_batch(tcfg, td, step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    jit, tit = jdata.DataIterator(jcfg, jd), tdata.DataIterator(tcfg, td)
    for _ in range(3):
        a, b = next(jit), next(tit)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    restored = tdata.DataIterator.restore(tcfg, td, tit.state())
    np.testing.assert_array_equal(next(restored)["labels"],
                                  next(jit)["labels"])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_on_stacked_tree():
    """The reference's tree (layer leaves stacked, so every layer leaf is
    decayed under ``ndim >= 2``), the same random gradients, three steps."""
    _, params, _, tree = _f32_pair("qwen3-4b")
    cfg_j = jadamw.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=6)
    cfg_t = tadamw.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=6)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    tp = [torch.tensor(a) for a in leaves]
    jst, tst = jadamw.init(params), tadamw.init(tp)
    jp = params
    japply = jax.jit(jadamw.apply_updates, static_argnums=3)
    r = np.random.default_rng(0)
    for _ in range(3):
        g = [(0.3 * r.standard_normal(a.shape)).astype(np.float32)
             for a in leaves]
        jp, jst, jm = japply(
            jp, jax.tree_util.tree_unflatten(treedef, g), jst, cfg_j)
        tst, tm = tadamw.apply_updates(tp, [torch.tensor(a) for a in g],
                                       tst, cfg_t)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(tst.count) == int(jst.count) == 3
    for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        for a, b in zip(got, jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


def test_schedule_matches_reference():
    for cfg in (dict(lr=5e-3), dict(lr=1.0, warmup_steps=10, total_steps=50,
                                    min_lr_frac=0.2)):
        cj, ct = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
        for s in (0, 1, ct.warmup_steps, (ct.warmup_steps
                                          + ct.total_steps) // 2,
                  ct.total_steps, ct.total_steps + 5):
            np.testing.assert_allclose(
                float(tadamw.schedule(ct, torch.tensor(s, dtype=torch.int32))),
                float(jadamw.schedule(cj, jnp.asarray(s, jnp.int32))),
                rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-base"])
def test_decay_mask_is_the_reference_rule_on_stacked_shapes(arch):
    jcfg, params, tcfg, tree = _f32_pair(arch)
    model = TM.params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    mask = dict(zip((n for n, _ in model.named_parameters()),
                    tstep.decay_mask(model)))
    for name, p in model.named_parameters():
        path = name.split(".")
        if path[0] == "top":
            want = np.ndim(tree[path[1]]) >= 2
        else:
            tag = {"groups": "g", "enc_groups": "enc_g"}[path[0]]
            want = np.ndim(tree[f"{tag}{path[1]}"][path[3]][path[4]]) >= 2
            assert want                     # every stacked layer leaf
        assert mask[name] == want, name
    assert not mask["top.final_norm"]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _steps(arch, accum, compute, n_steps=1, seed=0):
    """(reference loss, params), (port loss, params) after n_steps steps on
    the reference's data stream from the same float32 masters."""
    jcfg, params, tcfg, tree = _f32_pair(arch, seed)
    opt_j, opt_t = jadamw.AdamWConfig(lr=5e-3), tadamw.AdamWConfig(lr=5e-3)
    jfn = jax.jit(jstep.make_train_step(
        jcfg, opt_j, accum=accum,
        compute_dtype=None if compute is None else jnp.bfloat16))
    js = jstep.TrainState(params=params, opt=jadamw.init(params),
                          step=jnp.zeros((), jnp.int32))
    model = TM.params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    ts = tstep.TrainState(model, tadamw.init(model.parameters()),
                          torch.zeros((), dtype=torch.int32))
    tfn = tstep.make_train_step(tcfg, opt_t, accum=accum,
                                compute_dtype=compute)
    dcfg = jdata.DataConfig(seed=seed, batch=4, seq_len=32)
    for i in range(n_steps):
        batch = jdata.make_batch(jcfg, dcfg, i)
        js, jm = jfn(js, batch)
        ts, tm = tfn(ts, batch)
    assert int(ts.step) == n_steps
    return (float(jm["loss"]), js.params, float(jm["grad_norm"])), \
        (float(tm["loss"]), to_tree(ts.model),
         float(tm["grad_norm"]))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference_f32(accum):
    (jl, jp, jg), (tl, tp, tg) = _steps("qwen3-4b", accum, None)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5)
    flat_j, flat_t = jax.tree_util.tree_leaves(jp), \
        jax.tree_util.tree_leaves(tp)
    assert len(flat_j) == len(flat_t)
    for got, want in zip(flat_t, flat_j):
        _close(got, want, 0.0, 1e-4)


def test_train_step_bf16_loss_matches_reference():
    (jl, _, _), (tl, tp, _) = _steps("qwen3-4b", 2, torch.bfloat16)
    assert abs(tl - jl) <= 2e-2 * abs(jl)
    assert all(np.isfinite(a).all() for a in jax.tree_util.tree_leaves(tp))


def _random_batch(cfg, B=4, S=32, seed=7):
    """tests/test_models.py's ``_batch``: numpy from a seed."""
    rng = np.random.default_rng(seed)
    out = {}
    text = S - (cfg.vision_prefix_tokens or 0)
    if cfg.is_encoder_decoder:
        out["frames"] = (0.1 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
    if cfg.vision_prefix_tokens:
        out["patches"] = (0.1 * rng.standard_normal(
            (B, cfg.vision_prefix_tokens, cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, text + 1)).astype(np.int32)
    out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
    return out


def train_losses(arch: str, n_steps: int = 8):
    """Losses of ``n_steps`` port steps (bf16 compute, lr 5e-3) on one batch,
    as tests/test_models.py:54 trains the reference."""
    cfg = tconfigs.get_smoke(arch)
    state = tstep.init_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = tstep.make_train_step(cfg, tadamw.AdamWConfig(lr=5e-3))
    batch = _random_batch(cfg)
    losses = []
    for _ in range(n_steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    return losses


def test_qwen_loss_falls_on_one_batch():
    losses = train_losses("qwen3-4b")
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_remat_policies_agree():
    """"full", "dots" and "none" give one loss and one gradient."""
    _, _, tcfg, tree = _f32_pair("qwen3-4b")
    batch = {k: torch.as_tensor(v)
             for k, v in _random_batch(tcfg, B=2, S=16).items()}
    results = []
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat_policy=policy)
        model = TM.params_from_numpy(cfg, tree, device="cpu",
                                     trainable=True)
        loss = TM.forward_train(model, cfg, batch)
        loss.backward()
        results.append((loss.item(), [p.grad.clone()
                                      for p in model.parameters()]))
    for loss, grads in results[1:]:
        assert loss == results[0][0]
        for a, b in zip(grads, results[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="remat policy"):
        TM.forward_train(model, dataclasses.replace(tcfg,
                                                    remat_policy="some"),
                         batch)


# ---------------------------------------------------------------------------
# the CLI, guards
# ---------------------------------------------------------------------------

def test_train_cli_improves_loss(capsys):
    rc = train_cli.main(["--arch", "qwen3-4b", "--steps", "12", "--batch",
                         "4", "--seq", "32", "--lr", "5e-3", "--device",
                         "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["improved"] is True


def test_training_modules_import_no_jax():
    code = ("import sys, repro_torch.launch.train, repro_torch.train.step, "
            "repro_torch.optim.adamw, repro_torch.data.pipeline\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(REPO / "src"),
                                       "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
