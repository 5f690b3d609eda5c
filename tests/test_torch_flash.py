"""Attention kernels of the PyTorch port: their plain PyTorch versions
against the JAX package (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, its jnp oracle, and the model stack's
``attend``), the rule that picks a kernel, and -- on a Hopper card only --
each CUDA kernel (SIMT, wgmma, split-KV) against its plain version.

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


# ---------------------------------------------------------------------------
# The plain versions of the wgmma and split-KV kernels against the JAX
# package; the dispatch rule; on the card, each kernel against its plain
# version
# ---------------------------------------------------------------------------

NEW_PLAINS = {"tensor_core": tfa.tensor_core_attention_plain,
              "split_kv": tfa.split_kv_attention_plain}


def _port_layout(case, seed=0):
    """A reference case as the port's [B, S, heads, D] tensors and
    positions (query i at position Skv - Sq + i, slot j at j)."""
    B, H, KH, Sq, Skv, D, causal, window, cap, dtype = case
    q, k, v = (torch.as_tensor(a).transpose(1, 2).contiguous()
               .to(getattr(torch, dtype))
               for a in _qkv(B, H, KH, Sq, Skv, D, seed))
    qpos = torch.arange(Skv - Sq, Skv, dtype=torch.int32)
    kpos = torch.arange(Skv, dtype=torch.int32)
    return q, k, v, dict(q_positions=qpos, kv_positions=kpos, causal=causal,
                         window=window, logit_cap=cap)


@pytest.mark.parametrize("plain", sorted(NEW_PLAINS))
@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_kernel_plains_vs_pallas_and_oracle(case, plain):
    """tensor_core_attention_plain (P rounded to bf16 before P . V) and
    split_kv_attention_plain (per-split partials, log-sum-exp combine)
    against the Pallas kernel in interpret mode and its jnp oracle."""
    B, H, KH, Sq, Skv, D, causal, window, cap, dtype = case
    arrs = _qkv(B, H, KH, Sq, Skv, D)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    jkw = dict(causal=causal, window=window, logit_cap=cap,
               q_offset=Skv - Sq)
    q, k, v, kw = _port_layout(case)
    got = NEW_PLAINS[plain](q, k, v, **kw).transpose(1, 2)
    assert got.dtype == torch.float32 and got.shape == (B, H, Sq, D)
    got = _f32(got.to(q.dtype))
    np.testing.assert_allclose(got, _f32(jops.flash_attention(
        jq, jk, jv, **jkw)), atol=_atol(dtype))
    np.testing.assert_allclose(got, _f32(jref.flash_attention_ref(
        jq, jk, jv, **jkw)), atol=_atol(dtype))


@pytest.mark.parametrize("plain", sorted(NEW_PLAINS))
@pytest.mark.parametrize("Sq,window,cap", [
    (1, None, None), (4, 10, None), (8, None, 30.0),
    (9, None, None), (16, 10, 50.0), (24, 6, None)],
    ids=lambda x: str(x))
def test_kernel_plains_match_reference_on_ring_buffer(Sq, window, cap,
                                                      plain):
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
    got = NEW_PLAINS[plain](*map(torch.as_tensor, (q, k, v)),
                            q_positions=torch.as_tensor(qpos),
                            kv_positions=torch.as_tensor(RING), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_split_kv_plain_dead_splits_and_masked_rows():
    """Splits whose slots are all -1 contribute nothing; a row masked in
    every split gives 0, not NaN."""
    B, H, KH, D, Skv = 1, 4, 2, 16, 3 * tfa.SPLIT_KV_CHUNK
    r = np.random.default_rng(11)
    q, k, v = (torch.as_tensor(r.standard_normal(s, dtype=np.float32))
               for s in ((B, 2, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))
    kpos = torch.full((Skv,), -1, dtype=torch.int32)
    c = tfa.SPLIT_KV_CHUNK
    kpos[c:c + 20] = torch.arange(100, 120, dtype=torch.int32)
    # row 0 sees slots c..c+9 of split 1 only; row 1 (position 50) sees none
    qpos = torch.tensor([109, 50], dtype=torch.int32)
    kw = dict(q_positions=qpos, kv_positions=kpos)
    got = tfa.split_kv_attention_plain(q, k, v, **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, tfa.attention_plain(q, k, v, **kw),
                               rtol=0, atol=1e-6)
    assert float(got[:, 1].abs().max()) == 0.0
    assert float(got[:, 0].abs().max()) > 0.0
    # no unmasked slot anywhere: every row 0
    none = tfa.split_kv_attention_plain(
        q, k, v, q_positions=qpos,
        kv_positions=torch.full((Skv,), -1, dtype=torch.int32))
    assert float(none.abs().max()) == 0.0
    assert float(tfa.tensor_core_attention_plain(
        q, k, v, q_positions=qpos,
        kv_positions=torch.full((Skv,), -1, dtype=torch.int32)
    ).abs().max()) == 0.0


@pytest.mark.parametrize("dtype,D,Dv,rows,want", [
    # the serving path: qwen3-4b prefill (Sq 1024 x G 4) and decode (G 4)
    (torch.bfloat16, 128, 128, 4096, "wgmma"),
    (torch.bfloat16, 128, 128, 4, "split_kv"),
    # hymba's 64-wide heads, G 5
    (torch.bfloat16, 64, 64, 5 * 512, "wgmma"),
    (torch.bfloat16, 64, 64, 5, "split_kv"),
    # float32 prefill goes to the SIMT kernel; bf16 head dims that are
    # multiples of 8 up to D 192 / Dv 128 to the wgmma kernel, in
    # zero-padded 64-column boxes
    (torch.float32, 128, 128, 4096, "simt"),
    (torch.float32, 64, 64, 128, "simt"),
    (torch.bfloat16, 16, 16, 128, "wgmma"),
    (torch.bfloat16, 24, 24, 64, "wgmma"),
    (torch.bfloat16, 48, 48, 400, "wgmma"),
    (torch.bfloat16, 256, 256, 100, "simt"),      # D > 192
    (torch.bfloat16, 128, 64, 4096, "wgmma"),     # Dv != D
    # h2o-danube-3-4b's head dim 120 (G 4), the smoke configs' 32 and the
    # MLA smoke's (48, 32): wgmma in bf16, SIMT in float32
    (torch.bfloat16, 120, 120, 4096, "wgmma"),
    (torch.float32, 120, 120, 4096, "simt"),
    (torch.bfloat16, 120, 120, 4, "split_kv"),
    (torch.bfloat16, 32, 32, 128, "wgmma"),
    (torch.bfloat16, 48, 32, 64, "wgmma"),
    (torch.float32, 48, 32, 64, "simt"),
    # deepseek-v2's MLA prefill (K of 128 + 64 rope dims, V of 128, G 1):
    # the wgmma kernel in bf16, the SIMT kernel in float32, split-KV at
    # 16 rows; past D 192 or Dv 128 the SIMT kernel
    (torch.bfloat16, 192, 128, 4096, "wgmma"),
    (torch.float32, 192, 128, 4096, "simt"),
    (torch.bfloat16, 192, 128, 16, "split_kv"),
    (torch.bfloat16, 192, 192, 4096, "simt"),
    (torch.bfloat16, 128, 192, 4096, "simt"),
    (torch.bfloat16, 192, 64, 4096, "wgmma"),
    (torch.bfloat16, 200, 128, 4096, "simt"),     # D > 192
    (torch.bfloat16, 120, 20, 4096, "simt"),      # Dv not a multiple of 8
    # few rows: split-KV in either dtype, up to 16 rows and 256 wide
    (torch.float32, 128, 128, 4, "split_kv"),
    (torch.bfloat16, 256, 256, 16, "split_kv"),
    (torch.float32, 48, 24, 16, "split_kv"),
    (torch.bfloat16, 128, 128, 17, "wgmma"),
    (torch.float32, 128, 128, 17, "simt"),
    # rows of K/V not a whole number of 16 bytes: SIMT
    (torch.bfloat16, 20, 20, 4, "simt"),
    (torch.bfloat16, 20, 20, 4096, "simt"),
], ids=lambda x: str(x).replace("torch.", ""))
def test_dispatch_rule(dtype, D, Dv, rows, want):
    assert tfa.choose_kernel(dtype, D, Dv, rows) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plain", ["tensor_core", "attention_plain"])
def test_plains_at_mla_dims_vs_reference_attend(plain, dtype):
    """At MLA's prefill dims (D 192, Dv 128) the wgmma kernel's plain
    version and ``attention_plain`` against the JAX package's ``attend``:
    B 1, H = KH 2, Sq 130 (past two 64-slot tiles and a 128-row block),
    Skv 200 with 8 unwritten (-1) slots, causal.  atol 2e-3 in float32,
    2e-2 in bfloat16 (the tensor-core plain rounds P before P . V)."""
    B, H, Sq, Skv, D, Dv = 1, 2, 130, 200, 192, 128
    r = np.random.default_rng(23)
    q = r.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = r.standard_normal((B, Skv, H, D), dtype=np.float32)
    v = r.standard_normal((B, Skv, H, Dv), dtype=np.float32)
    kpos = np.arange(Skv, dtype=np.int32)
    kpos[r.choice(Skv, 8, replace=False)] = -1
    qpos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    want = _jattend(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                    q_positions=jnp.asarray(qpos),
                    kv_positions=jnp.asarray(kpos), causal=True)
    fn = NEW_PLAINS.get(plain, tfa.attention_plain)
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = fn(tq, tk, tv, q_positions=torch.as_tensor(qpos),
             kv_positions=torch.as_tensor(kpos), causal=True)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, Dv)
    np.testing.assert_allclose(_f32(got.to(tq.dtype)), _f32(want),
                               atol=_atol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plain", ["tensor_core", "attention_plain"])
@pytest.mark.parametrize("H,KH,D,Dv,window,cap", [
    (8, 2, 120, 120, 24, 30.0),    # h2o-danube-3-4b's head dim, G 4
    (2, 2, 48, 32, None, None),    # the MLA smoke's (D, Dv)
], ids=["d120", "d48_dv32"])
def test_plains_at_padded_head_dims_vs_reference_attend(H, KH, D, Dv,
                                                        window, cap, plain,
                                                        dtype):
    """At head dims the wgmma kernel takes in zero-padded boxes -- D 120
    at G 4 with a window and a softcap, and (48, 32) -- the wgmma kernel's
    plain version and ``attention_plain`` against the JAX package's
    ``attend``: B 2, Sq 70 (past one 64-slot tile), Skv 100 (not a whole
    number of tiles) with 5 unwritten (-1) slots, causal.  atol 1e-4 in
    float32 (one arithmetic, summed in another order), 2e-2 in bfloat16
    (the tensor-core plain rounds P before P . V)."""
    B, Sq, Skv = 2, 70, 100
    r = np.random.default_rng(D + Dv)
    q = r.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = r.standard_normal((B, Skv, KH, D), dtype=np.float32)
    v = r.standard_normal((B, Skv, KH, Dv), dtype=np.float32)
    kpos = np.arange(Skv, dtype=np.int32)
    kpos[r.choice(Skv, 5, replace=False)] = -1
    qpos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kw = dict(causal=True, window=window, logit_cap=cap)
    want = _jattend(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                    q_positions=jnp.asarray(qpos),
                    kv_positions=jnp.asarray(kpos), **kw)
    fn = NEW_PLAINS.get(plain, tfa.attention_plain)
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = fn(tq, tk, tv, q_positions=torch.as_tensor(qpos),
             kv_positions=torch.as_tensor(kpos), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, Dv)
    assert tfa.choose_kernel(torch.bfloat16, D, Dv, Sq * H // KH) == "wgmma"
    np.testing.assert_allclose(_f32(got.to(tq.dtype)), _f32(want),
                               atol=1e-4 if dtype == "float32" else 2e-2)


def test_launch_counts_have_one_key_per_kernel():
    assert set(tfa.LAUNCHES) == {"flash_attention",
                                 "flash_attention_split_kv_lse"} | {
        f"flash_attention_{n}" for n in tfa.KERNELS}
    tfa.reset_launches()
    assert not any(tfa.LAUNCHES.values())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,Sq,Skv,D,Dv,window,cap,causal", [
    (2, 8, 2, 64, 64, 128, 128, None, None, True),      # one kv tile
    (1, 8, 8, 128, 256, 64, 64, None, 50.0, True),      # G 1, softcap
    (2, 10, 2, 33, 65, 64, 64, 16, None, True),         # G 5, window
    (1, 8, 2, 100, 80, 128, 128, None, None, False),    # non-causal
    (1, 256, 1, 2, 70, 64, 64, None, None, True),       # G > 128
    (2, 8, 2, 300, 700, 128, 128, 100, None, True),     # skipped tiles
    # MLA's prefill dims: K of 192 (three 64-column boxes), V of 128
    (2, 8, 2, 64, 64, 192, 128, None, None, True),      # one kv tile
    (2, 128, 128, 130, 200, 192, 128, None, None, True),   # G 1, 128 heads
    (2, 8, 8, 300, 700, 192, 128, 100, None, True),     # skipped, masked
    (1, 4, 4, 128, 256, 192, 128, None, 50.0, True),    # softcap
    (1, 4, 4, 20, 0, 192, 128, None, None, True),       # Skv == 0
    # head dims in zero-padded boxes: danube's 120 (G 4), the smoke's 32,
    # the MLA smoke's (48, 32), (128, 64); Skv not a whole number of tiles
    (2, 32, 8, 130, 200, 120, 120, 64, 30.0, True),     # window, softcap
    (1, 8, 2, 70, 70, 120, 120, None, None, False),     # one partial tile
    (2, 4, 1, 96, 160, 32, 32, 32, None, True),
    (2, 4, 4, 64, 100, 48, 32, None, None, True),
    (1, 8, 2, 100, 150, 128, 64, None, 50.0, True),
    (1, 4, 4, 20, 0, 120, 120, None, None, True),       # Skv == 0
])
def test_wgmma_kernel_vs_plain(hopper, B, H, KH, Sq, Skv, D, Dv, window,
                               cap, causal):
    g = torch.Generator(device=hopper).manual_seed(Sq)
    q, k, v = (torch.randn(s, generator=g, device=hopper).bfloat16()
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, Dv)))
    kw = dict(q_positions=torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                                       device=hopper),
              kv_positions=torch.arange(Skv, dtype=torch.int32,
                                        device=hopper),
              causal=causal, window=window, logit_cap=cap)
    n = tfa.LAUNCHES["flash_attention_wgmma"]
    got = tfa.flash_attention_cuda(q, k, v, kw.pop("q_positions"),
                                   kw.pop("kv_positions"), **kw).float()
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_wgmma"] == n + 1
    assert got.shape == (B, Sq, H, Dv)
    if Skv == 0:
        assert float(got.abs().max()) == 0.0
    kw.update(q_positions=torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                                       device=hopper),
              kv_positions=torch.arange(Skv, dtype=torch.int32,
                                        device=hopper))
    want = tfa.tensor_core_attention_plain(q, k, v, **kw).bfloat16().float()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)
    ref = tfa.attention_plain(q, k, v, **kw).bfloat16().float()
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2)


@pytest.mark.gpu
def test_wgmma_refuses_other_head_dim_pairs(hopper):
    """Forced onto (256, 128), (128, 192) or (120, 20) -- past D 192, past
    Dv 128, Dv not a multiple of 8 -- the wrapper raises from ``_takes``
    and launches nothing."""
    pos = torch.arange(64, dtype=torch.int32, device=hopper)
    for D, Dv in ((256, 128), (128, 192), (120, 20)):
        q, k = (torch.zeros((1, 64, 2, D), device=hopper).bfloat16()
                for _ in range(2))
        v = torch.zeros((1, 64, 2, Dv), device=hopper).bfloat16()
        before = dict(tfa.LAUNCHES)
        with pytest.raises(ValueError, match="wgmma kernel does not take"):
            tfa.flash_attention_cuda(q, k, v, pos, pos, kernel="wgmma")
        assert tfa.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,Sq,D,Dv,window,cap", [
    (2, 4, 2, 1, 32, 32, None, None),
    (1, 8, 8, 1, 64, 64, None, 50.0),
    (2, 4, 2, 5, 48, 24, 10, 20.0),          # Dv != D, window, softcap
    (2, 8, 2, 2, 256, 256, None, None),       # the widest head
    (2, 16, 4, 4, 128, 128, None, None),      # 16 rows per kv head
])
def test_split_kv_kernel_vs_plain_on_ring_buffer(hopper, dtype, B, H, KH,
                                                 Sq, D, Dv, window, cap):
    """Ring-buffer positions: a split of -1 slots and wrapped positions."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=hopper).manual_seed(Sq)
    ring = torch.as_tensor(np.concatenate([RING, np.full(
        tfa.SPLIT_KV_CHUNK, -1, np.int32), RING]), device=hopper)
    Skv = ring.numel()
    q, k, v = (torch.randn(s, generator=g, device=hopper).to(dt)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, Dv)))
    qpos = torch.arange(28 - Sq, 28, dtype=torch.int32, device=hopper)
    kw = dict(causal=True, window=window, logit_cap=cap)
    n = tfa.LAUNCHES["flash_attention_split_kv"]
    got = tfa.flash_attention_cuda(q, k, v, qpos, ring, **kw).float()
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_split_kv"] == n + 1
    for plain in (tfa.split_kv_attention_plain, tfa.attention_plain):
        want = plain(q, k, v, q_positions=qpos, kv_positions=ring, **kw)
        torch.testing.assert_close(got, want.to(dt).float(), rtol=0,
                                   atol=_atol(dtype))


@pytest.mark.gpu
def test_new_kernels_fully_masked_rows_are_zero(hopper):
    for Sq, dt, kernel, D, Dv in ((16, torch.bfloat16, "wgmma", 64, 64),
                                  (20, torch.bfloat16, "wgmma", 120, 120),
                                  (20, torch.bfloat16, "wgmma", 48, 32),
                                  (1, torch.float32, "split_kv", 64, 64),
                                  (2, torch.bfloat16, "split_kv", 64, 64)):
        g = torch.Generator(device=hopper).manual_seed(Sq)
        q, k, v = (torch.randn(s, generator=g, device=hopper).to(dt)
                   for s in ((1, Sq, 4, D), (1, 200, 2, D),
                             (1, 200, 2, Dv)))
        got = tfa.flash_attention_cuda(
            q, k, v, torch.arange(-64, -64 + Sq, dtype=torch.int32,
                                  device=hopper),
            torch.arange(200, dtype=torch.int32, device=hopper),
            kernel=kernel)
        assert bool(torch.isfinite(got).all())
        assert float(got.abs().max()) == 0.0


def _lse64(q, k, kv_pos, q_pos, window, cap):
    """Each row's log-sum-exp [B, H, Sq] of its unmasked scores, in float64
    (-inf where none), straight from the definition."""
    B, Sq, H, Dh = q.shape
    KH = k.shape[2]
    qd, kd = q.double().numpy(), k.double().numpy()
    kd = np.repeat(kd, H // KH, axis=2)                  # [B, Skv, H, D]
    s = np.einsum("bqhd,bkhd->bhqk", qd / np.sqrt(Dh), kd)
    if cap is not None:
        s = cap * np.tanh(s / cap)
    rel = q_pos.numpy()[:, None].astype(np.int64) - kv_pos.numpy()[None]
    ok = (kv_pos.numpy() >= 0)[None] & (rel >= 0)
    if window is not None:
        ok &= rel < window
    s = np.where(ok[None, None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    m_safe = np.where(np.isneginf(m), 0.0, m)
    with np.errstate(divide="ignore"):
        return (m_safe + np.log(np.exp(s - m_safe).sum(-1, keepdims=True))
                )[..., 0]


@pytest.mark.parametrize("window,cap", [(None, None), (40, 30.0)])
def test_split_kv_plain_lse_vs_float64(window, cap):
    """``split_kv_attention_plain``'s lse against a float64 log-sum-exp over
    a ring with dead (-1) slots, across several splits, one query row
    fully masked (-inf, output 0); its output the one without lse."""
    B, H, KH, Dh, Skv = 2, 8, 2, 32, 3 * tfa.SPLIT_KV_CHUNK + 17
    r = np.random.default_rng(13)
    q, k, v = (torch.as_tensor(r.standard_normal(s, dtype=np.float32))
               for s in ((B, 2, H, Dh), (B, Skv, KH, Dh), (B, Skv, KH, Dh)))
    kv_pos = torch.as_tensor(np.where(r.random(Skv) < 0.2, -1,
                                      r.permutation(Skv)).astype(np.int32))
    q_pos = torch.tensor([Skv - 1, -5], dtype=torch.int32)  # row 1: nothing
    kw = dict(q_positions=q_pos, kv_positions=kv_pos, window=window,
              logit_cap=cap)
    out, lse = tfa.split_kv_attention_plain(q, k, v, return_lse=True, **kw)
    assert lse.shape == (B, H, 2) and lse.dtype == torch.float32
    want = _lse64(q, k, kv_pos, q_pos, window, cap)
    assert np.isneginf(want[:, :, 1]).all() and np.isfinite(
        want[:, :, 0]).all()
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(lse.numpy()[fin], want[fin], rtol=1e-6,
                               atol=1e-5)
    torch.testing.assert_close(out, tfa.split_kv_attention_plain(q, k, v,
                                                                 **kw),
                               rtol=0, atol=0)
    assert float(out[:, 1].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_split_kv_kernel_lse_vs_plain(hopper, dtype):
    """The split-KV kernel's lse output (``return_lse``) against its plain
    version's, atol 2e-3, a fully masked row -inf in both; its output as
    without lse, the launch counted once as split_kv and once as
    split_kv_lse."""
    B, H, KH, Dh, Skv = 2, 8, 2, 64, 3 * tfa.SPLIT_KV_CHUNK + 17
    r = np.random.default_rng(14)
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(r.standard_normal(s, dtype=np.float32),
                               device=hopper).to(dt)
               for s in ((B, 2, H, Dh), (B, Skv, KH, Dh), (B, Skv, KH, Dh)))
    kv_pos = torch.as_tensor(np.where(r.random(Skv) < 0.2, -1,
                                      r.permutation(Skv)).astype(np.int32),
                             device=hopper)
    q_pos = torch.tensor([Skv - 1, -5], dtype=torch.int32, device=hopper)
    kw = dict(window=40, logit_cap=30.0)
    n = tfa.LAUNCHES["flash_attention_split_kv"]
    n_lse = tfa.LAUNCHES["flash_attention_split_kv_lse"]
    out, lse = tfa.flash_attention_cuda(q, k, v, q_pos, kv_pos,
                                        return_lse=True, **kw)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_split_kv"] == n + 1
    assert tfa.LAUNCHES["flash_attention_split_kv_lse"] == n_lse + 1
    p_out, p_lse = tfa.split_kv_attention_plain(
        q, k, v, q_positions=q_pos, kv_positions=kv_pos, return_lse=True,
        **kw)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(p_lse))
    fin = torch.isfinite(p_lse)
    torch.testing.assert_close(lse[fin], p_lse[fin], rtol=0, atol=2e-3)
    assert torch.equal(out, tfa.flash_attention_cuda(q, k, v, q_pos, kv_pos,
                                                     **kw))
    torch.testing.assert_close(out.float(), p_out, rtol=0,
                               atol=_atol(dtype))
