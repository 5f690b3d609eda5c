"""Training gradients of every block family of the PyTorch port against
``jax.grad`` of the reference's ``forward_train``, leaf by leaf, in float32
(the JAX weights carried across as float32 masters), h2o-danube-3-4b's
too at narrow width with its head dim of 120, and its bf16 attention
gradients against ``jax.vjp`` (2e-2 of each tensor's largest magnitude);
the loss falling over 8 steps on one batch for all ten configurations in
the port alone (as tests/test_models.py:54 holds the reference); and, on
a Hopper card only,
the differentiable attention with the CUDA kernels' forward against the
same ``Function`` with the plain forward and against autograd through
``attention_plain``.

Tolerances: per leaf, the largest gradient difference within 1e-3 of the
leaf's largest |g| (float32 in another summation order; the reference side
runs ``remat_policy="none"``, which changes no value and saves compile
time).  Looser where a leaf's gradient is zero in exact arithmetic and
both packages give rounding noise: sLSTM's input-gate bias ``bi`` (a shift
of it shifts the stabiliser m by as much, so every step's input and forget
weights, and h, stay as they were; |g| ~1e-9 on both sides, of either
sign).  A leaf whose largest |g| is below 1e-5 of the model's largest is
held to 1e-3 of that floor, 1e-8 of the model's largest |g|.  On the
card 2e-3 of each gradient's largest magnitude in float32 and 2e-2 in bf16
(the kernels' own tolerances, ``PERF.md`` §2)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers, model as JM
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import model as TM

from test_torch_train import _random_batch, to_tree, train_losses


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


# a config of each block family: softcap and sliding window, MoE, MLA with
# MoE, the recurrent blocks, attention beside mamba, encoder-decoder, VLM
FAMILIES = ("gemma2-27b", "olmoe-1b-7b", "deepseek-v2-236b", "xlstm-1.3b",
            "hymba-1.5b", "whisper-base", "internvl2-2b")


# h2o-danube-3-4b at narrow width with its real head dim of 120 (the wgmma
# kernel's zero-padded boxes on the card) and a 16-slot window, which a
# 32-token batch crosses
DANUBE_NARROW = dict(n_layers=2, n_heads=4, n_kv_heads=1, d_head=120,
                     sliding_window=16)


@pytest.mark.parametrize("arch", FAMILIES + ("h2o-danube-3-4b",))
def test_gradients_match_jax_grad(arch):
    overrides = DANUBE_NARROW if arch == "h2o-danube-3-4b" else {}
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch, **overrides),
                               dtype="float32", remat_policy="none")
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch, **overrides),
                               dtype="float32")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    batch = _random_batch(jcfg, B=2, S=32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(JM.forward_train),
                              static_argnums=1)(params, jcfg, batch)

    model = TM.params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    loss_t = TM.forward_train(model, tcfg, {k: torch.as_tensor(v)
                                            for k, v in batch.items()})
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
    flat_g, _ = jax.tree_util.tree_flatten_with_path(
        to_tree(model, lambda p: p.grad))
    flat_j = jax.tree_util.tree_leaves(grads_j)
    assert len(flat_g) == len(flat_j)
    floor = 1e-5 * max(float(jnp.abs(w).max()) for w in flat_j)
    for (path, g), want in zip(flat_g, flat_j):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        err = float(np.abs(g - want).max())
        assert err <= 1e-3 * max(scale, floor), (
            jax.tree_util.keystr(path), err, scale)


def test_danube_bf16_attend_gradients_match_jax_vjp():
    """The narrow danube's attention in bf16 (B 2, S 32, 4 query heads on
    1 kv head of 120, window 16, 3 unwritten kv slots): ``attend``'s
    output and dq / dk / dv against ``jax.vjp`` of the reference's
    ``attend`` on the same bf16 inputs, within 2e-2 of each tensor's
    largest magnitude (both round in bf16, at other places)."""
    B, S, H, KH, D, W = 2, 32, 4, 1, 120, DANUBE_NARROW["sliding_window"]
    r = np.random.default_rng(29)
    q, do = (r.standard_normal((B, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (r.standard_normal((B, S, KH, D)).astype(np.float32)
            for _ in range(2))
    qp = np.arange(S, dtype=np.int32)
    kp = qp.copy()
    kp[:3] = -1

    def ref(q, k, v):
        return jlayers.attend(q, k, v, q_positions=jnp.asarray(qp),
                              kv_positions=jnp.asarray(kp), causal=True,
                              window=W)

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    out_j, vjp = jax.vjp(ref, bf(q), bf(k), bf(v))
    grads_j = vjp(jnp.asarray(do, out_j.dtype))
    leaves = [torch.tensor(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out_t = tfa.attend(*leaves, torch.tensor(qp), torch.tensor(kp),
                       causal=True, window=W)
    out_t.backward(torch.tensor(do).to(out_t.dtype))
    for got, want in zip([out_t] + [t.grad for t in leaves],
                         [out_j] + list(grads_j)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        got = got.detach().float().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_loss_falls_for_every_config(arch):
    losses = train_losses(arch)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# On the card: the Function with the CUDA forward against the plain one
# ---------------------------------------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _plain_in_dtype(q, k, v, **kw):
    return tfa.attention_plain(q, k, v, **kw).to(q.dtype)


GPU_CASES = [
    # B, H, KH, S, D, dtype, window, cap, dead kv slots
    (2, 32, 8, 256, 128, torch.bfloat16, None, None, 0),   # wgmma, qwen
    (1, 8, 2, 200, 64, torch.bfloat16, 64, 30.0, 0),       # wgmma, D 64
    (2, 4, 2, 96, 32, torch.float32, 32, 30.0, 5),         # SIMT
    (2, 32, 8, 256, 120, torch.bfloat16, 64, 30.0, 5),     # wgmma, D 120
    (2, 4, 1, 96, 32, torch.bfloat16, 32, None, 0),        # wgmma, D 32
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES,
                         ids=[f"g{i}" for i in range(len(GPU_CASES))])
def test_cuda_function_gradients_vs_plain(hopper, case, monkeypatch):
    B, H, KH, S, D, dtype, window, cap, dead = case
    g = torch.Generator(device=hopper).manual_seed(S)
    q, k, v, do = (torch.randn(s, generator=g, device=hopper).to(dtype)
                   for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D),
                             (B, S, H, D)))
    pos = torch.arange(S, dtype=torch.int32, device=hopper)
    kpos = pos.clone()
    kpos[:dead] = -1

    def grads(fn=None, plain_autograd=False):
        if fn is not None:
            monkeypatch.setattr(tfa, "flash_attention_cuda", fn)
        leaves = [t.detach().float().requires_grad_() if plain_autograd
                  else t.detach().clone().requires_grad_() for t in (q, k, v)]
        kw = dict(causal=True, window=window, logit_cap=cap)
        if plain_autograd:
            out = tfa.attention_plain(*leaves, q_positions=pos,
                                      kv_positions=kpos, **kw)
        else:
            out = tfa.attend(*leaves, pos, kpos, **kw)
        out.backward(do.to(out.dtype))
        monkeypatch.undo()
        return [t.grad.float() for t in leaves]

    real = tfa.flash_attention_cuda
    kernel = grads()
    plain = grads(lambda q, k, v, qp, kp, **kw: _plain_in_dtype(
        q, k, v, q_positions=qp, kv_positions=kp, **kw))
    exact = grads(plain_autograd=True)
    assert tfa.flash_attention_cuda is real
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    for a, b, c in zip(kernel, plain, exact):
        assert a.abs().max() > 0
        for want in (b, c):
            assert (a - want).abs().max() <= tol * want.abs().max()


@pytest.mark.gpu
def test_cuda_ops_flash_attention_has_grad_fn(hopper):
    """The public wrapper on CUDA tensors that require grad goes through
    the Function: a grad_fn, and attend's gradients."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=hopper).manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=g, device=hopper).bfloat16()
                   for s in ((2, 256, 32, 128), (2, 256, 8, 128),
                             (2, 256, 8, 128), (2, 256, 32, 128)))
    leaves = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    out.backward(do.transpose(1, 2))
    pos = torch.arange(256, dtype=torch.int32, device=hopper)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.attend(*ref, pos, pos, causal=True).backward(do)
    for a, b in zip(leaves, ref):
        want = b.grad.float()
        assert (a.grad.transpose(1, 2).float() - want).abs().max() \
            <= 2e-2 * want.abs().max()

