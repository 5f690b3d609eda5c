"""Attention kernel of the PyTorch port: its plain PyTorch versions against
the JAX package (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, its jnp oracle, and the model stack's
``attend``), and -- on a Hopper card only -- the CUDA kernel against its
plain version.

Tolerances: atol 2e-3 in float32 and 2e-2 in bfloat16 against the kernel
and its oracle (tests/test_kernels.py: the Pallas kernel casts q before
scaling it, the chunked oracle after); 1e-5 for ``attend`` in float32
(the same arithmetic, summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa, ops as tops, \
    ref as tref
from repro_torch.models import layers as tlayers

FLASH_CASES = [
    # B, H, KH, Sq, Skv, D, causal, window, cap, dtype  (tests/test_kernels.py)
    (2, 4, 2, 64, 64, 32, True, None, None, "float32"),
    (1, 8, 8, 128, 256, 64, True, None, 50.0, "float32"),
    (2, 4, 1, 96, 160, 32, True, 32, None, "float32"),
    (1, 2, 2, 48, 80, 16, False, None, None, "float32"),
    (2, 8, 4, 200, 200, 64, True, 64, 30.0, "float32"),
    (1, 4, 2, 64, 128, 32, True, None, None, "bfloat16"),
    (2, 2, 2, 33, 65, 24, True, None, None, "float32"),  # ragged blocks
]
IDS = [f"c{i}" for i in range(len(FLASH_CASES))]
# the reference's attend, compiled once per case (eager op-by-op dispatch
# costs more than the compile at these sizes)
_jattend = jax.jit(jlayers.attend,
                   static_argnames=("causal", "window", "logit_cap"))


def _qkv(B, H, KH, Sq, Skv, D, seed=0):
    """float32 numpy q [B, H, Sq, D], k/v [B, KH, Skv, D]."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, Sq, D), dtype=np.float32),
            r.standard_normal((B, KH, Skv, D), dtype=np.float32),
            r.standard_normal((B, KH, Skv, D), dtype=np.float32))


def _atol(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-3


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_plain_flash_vs_pallas_and_oracle(case):
    B, H, KH, Sq, Skv, D, causal, window, cap, dtype = case
    arrs = _qkv(B, H, KH, Sq, Skv, D)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs)
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=Skv - Sq)
    got = tops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == (B, H, Sq, D)
    np.testing.assert_allclose(_f32(got), _f32(jops.flash_attention(
        jq, jk, jv, **kw)), atol=_atol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(jref.flash_attention_ref(
        jq, jk, jv, **kw)), atol=_atol(dtype))


def test_plain_flash_fully_masked_rows_are_zero():
    """q before every kv position (q_offset past the start): zero output,
    no NaN -- in the port's plain version and in the Pallas kernel."""
    q, k, v = _qkv(1, 2, 2, 16, 32, 16, seed=3)
    got = tops.flash_attention(*map(torch.as_tensor, (q, k, v)),
                               causal=True, q_offset=-64)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                q_offset=-64)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ring-buffer cache of 24 slots after 28 writes: slots 0-3 wrapped to
# positions 24-27, slots 4-19 hold 4-19, slots 20-23 never written
RING = np.array(list(range(24, 28)) + list(range(4, 20)) + [-1] * 4,
                np.int32)


@pytest.mark.parametrize("Sq,window,cap", [
    (1, None, None), (4, 10, None), (8, None, 30.0),     # direct branch
    (9, None, None), (16, 10, 50.0), (24, 6, None)],     # chunked branch
    ids=lambda x: str(x))
def test_attend_matches_reference_on_ring_buffer(Sq, window, cap):
    B, H, KH, D = 2, 4, 2, 16
    r = np.random.default_rng(Sq)
    q = r.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = r.standard_normal((B, RING.size, KH, D), dtype=np.float32)
    v = r.standard_normal((B, RING.size, KH, D), dtype=np.float32)
    qpos = np.arange(28 - Sq, 28, dtype=np.int32)
    kw = dict(causal=True, window=window, logit_cap=cap)
    want = _jattend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    q_positions=jnp.asarray(qpos),
                    kv_positions=jnp.asarray(RING), **kw)
    got = tlayers.attend(torch.as_tensor(q), torch.as_tensor(k),
                         torch.as_tensor(v), q_positions=torch.as_tensor(qpos),
                         kv_positions=torch.as_tensor(RING), **kw)
    assert got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_attend_non_causal_masks_only_unwritten_slots():
    """causal=False: negative positions stay masked, nothing else is."""
    B, H, KH, D = 1, 2, 1, 8
    r = np.random.default_rng(7)
    q = r.standard_normal((B, 12, H, D), dtype=np.float32)
    k = r.standard_normal((B, RING.size, KH, D), dtype=np.float32)
    v = r.standard_normal((B, RING.size, KH, D), dtype=np.float32)
    qpos = np.zeros(12, np.int32)
    got = tlayers.attend(*map(torch.as_tensor, (q, k, v)),
                         q_positions=torch.as_tensor(qpos),
                         kv_positions=torch.as_tensor(RING), causal=False)
    want = _jattend(*map(jnp.asarray, (q, k, v)),
                    q_positions=jnp.asarray(qpos),
                    kv_positions=jnp.asarray(RING), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 2, 16)
    pos = torch.arange(4, dtype=torch.int32)
    before = dict(tfa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q, pos, pos)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention_cuda(q.half(), q.half(), q.half(), pos, pos)
    assert tfa.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_flash_kernel_vs_plain(hopper, case):
    B, H, KH, Sq, Skv, D, causal, window, cap, dtype = case
    q, k, v = (torch.as_tensor(a, device=hopper).to(getattr(torch, dtype))
               for a in _qkv(B, H, KH, Sq, Skv, D))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=Skv - Sq)
    n = tfa.LAUNCHES["flash_attention"]
    got = tops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == n + 1
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_atol(dtype))


@pytest.mark.gpu
def test_flash_kernel_fully_masked_rows_are_zero(hopper):
    q, k, v = (torch.as_tensor(a, device=hopper)
               for a in _qkv(1, 2, 2, 16, 32, 16, seed=3))
    got = tops.flash_attention(q, k, v, causal=True, q_offset=-64)
    assert bool(torch.isfinite(got).all())
    assert float(got.abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,Sq,D,Dv,window,cap", [
    (1, 128, 1, 3, 64, 64, None, None),      # G = 128: a position spans blocks
    (2, 4, 2, 10, 48, 24, 30, 20.0),         # Dv != D, window and softcap
    (2, 8, 2, 5, 256, 256, None, None),      # the widest head the kernel takes
])
def test_flash_kernel_vs_plain_on_ring_buffer(hopper, B, H, KH, Sq, D, Dv,
                                              window, cap):
    """Non-contiguous cache positions with -1 slots, wide GQA groups and
    Dv != D, through ``attend`` (the model path's entry)."""
    r = np.random.default_rng(Sq)
    as_t = lambda a: torch.as_tensor(a, device=hopper)
    q = as_t(r.standard_normal((B, Sq, H, D), dtype=np.float32))
    k = as_t(r.standard_normal((B, RING.size, KH, D), dtype=np.float32))
    v = as_t(r.standard_normal((B, RING.size, KH, Dv), dtype=np.float32))
    qpos = as_t(np.arange(28 - Sq, 28, dtype=np.int32))
    kw = dict(q_positions=qpos, kv_positions=as_t(RING), causal=True,
              window=window, logit_cap=cap)
    got = tlayers.attend(q, k, v, **kw)
    want = tfa.attention_plain(q, k, v, **kw)
    assert got.shape == (B, Sq, H, Dv)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
