"""Attention kernel of the model path: the CUDA kernel's launch wrapper and
its plain PyTorch versions.

  * ``flash_attention_cuda`` (``csrc/flash_attention.cu``) -- online-softmax
    attention with GQA folding, causal masking by positions, a sliding
    window and a tanh logit cap; float32 accumulation over float32 or
    bfloat16 inputs.  Replaces ``flash_attention_tpu``
    (src/repro/kernels/flash_attention.py:81), and serves every attention
    call of the port's model (prefill and decode against the cache).
  * ``flash_attention`` (chunked online softmax) and ``direct_attention``
    (one pass over all slots, for short q) -- the plain versions, line for
    line the reference's ``models/layers.py`` functions; ``attention_plain``
    chooses between them as the reference's ``attend`` does.

Layout ``[B, S, heads, D]``; query head h reads kv head ``h // G``.  The
positions decide the mask: a kv slot with a negative position is masked
(padding, or an unwritten ring-buffer cache slot), and with ``causal`` a
pair needs ``0 <= q_pos - kv_pos < window``.  A row with no unmasked slot
gives 0.  The wrapper launches the kernel for CUDA tensors and raises on
what the kernel does not take; ``models.layers.attend`` and
``kernels.ops.flash_attention`` pick the plain version only for tensors on
the CPU.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from . import _build

# kernel launches since the last reset
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
# Q sequence lengths up to this use the direct (unchunked) plain path
DECODE_DIRECT_MAX_Q = 8
# kv chunk of the chunked plain path when ``attention_plain`` dispatches to
# it (the reference's ``attend`` default)
PLAIN_KV_CHUNK = 512
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _mask(q_positions, kv_positions, causal: bool, window: Optional[int]):
    """[1, Sq, 1, 1, Skv] bool: the reference's mask, broadcast against
    scores laid out [B, Sq, KH, G, Skv]."""
    mask = (kv_positions >= 0)[None, None, None, None, :]
    if causal:
        rel = (q_positions[None, :, None, None, None]
               - kv_positions[None, None, None, None, :])
        mask = mask & (rel >= 0)
        if window is not None:
            mask = mask & (rel < window)
    return mask


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                    window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over kv chunks (the reference's
    ``layers.flash_attention``): q [B, Sq, H, D], k/v [B, Skv, KH, D(v)]
    -> [B, Sq, H, Dv] float32.  q is scaled in its own dtype, then cast."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qg = (q * scale).reshape(B, Sq, KH, G, D).float()
    neg_inf = torch.tensor(-math.inf, device=q.device)
    m = torch.full((B, Sq, KH, G), -math.inf, device=q.device)
    l = torch.zeros((B, Sq, KH, G), device=q.device)
    acc = torch.zeros((B, Sq, KH, G, Dv), device=q.device)
    for c0 in range(0, Skv, kv_chunk):
        kj = k[:, c0:c0 + kv_chunk].float()
        vj = v[:, c0:c0 + kv_chunk].float()
        pj = kv_positions[c0:c0 + kv_chunk]
        s = softcap(torch.einsum("bqhgd,bchd->bqhgc", qg, kj), logit_cap)
        mask = _mask(q_positions, pj, causal, window)
        s = torch.where(mask, s, neg_inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.exp(torch.where(torch.isneginf(m), 0.0, m) - m_safe)
        corr = torch.where(torch.isneginf(m), 0.0, corr)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgc,bchv->bqhgv", p,
                                                   vj)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(B, Sq, H, Dv)


def direct_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                     window: Optional[int] = None,
                     logit_cap: Optional[float] = None) -> torch.Tensor:
    """Unchunked attention for short q (the reference's
    ``layers.direct_attention``); q is cast, then scaled."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    qg = (q.float() / math.sqrt(D)).reshape(B, Sq, KH, G, D)
    s = softcap(torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()), logit_cap)
    mask = _mask(q_positions, kv_positions, causal, window)
    s = torch.where(mask, s, torch.tensor(-math.inf, device=q.device))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bqhgk,bkhv->bqhgv", p, v.float())
    out = out / torch.clamp_min(l, 1e-20)
    return out.reshape(B, Sq, H, Dv)


def attention_plain(q, k, v, *, q_positions, kv_positions, causal=True,
                    window: Optional[int] = None,
                    logit_cap: Optional[float] = None) -> torch.Tensor:
    """The reference's ``attend`` dispatch on the plain versions: direct
    for Sq <= 8, chunked (``PLAIN_KV_CHUNK`` slots) otherwise.  Returns
    float32."""
    kw = dict(q_positions=q_positions, kv_positions=kv_positions,
              causal=causal, window=window, logit_cap=logit_cap)
    if q.shape[1] <= DECODE_DIRECT_MAX_Q:
        return direct_attention(q, k, v, **kw)
    return flash_attention(q, k, v, kv_chunk=PLAIN_KV_CHUNK, **kw)


# ---------------------------------------------------------------------------
# CUDA launch wrapper
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, ndim: int, dev) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention_cuda(q, k, v, q_positions, kv_positions, *,
                         causal: bool = True, window: Optional[int] = None,
                         logit_cap: Optional[float] = None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu``: q [B, Sq, H, D], k [B, Skv, KH,
    D], v [B, Skv, KH, Dv] (float32 or bfloat16, one dtype), q_positions
    [Sq] and kv_positions [Skv] int32 -> [B, Sq, H, Dv] in q's dtype.
    D, Dv <= 256."""
    dev = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t, nm, dt, nd in ((q, "q", q.dtype, 4), (k, "k", q.dtype, 4),
                          (v, "v", q.dtype, 4),
                          (q_positions, "q_positions", torch.int32, 1),
                          (kv_positions, "kv_positions", torch.int32, 1)):
        _check(t, nm, dt, nd, dev)
    B, Sq, H, D = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, Skv, KH, D) or tuple(v.shape[:3]) != (B, Skv,
                                                                   KH):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads do not fold onto {KH} kv heads")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {D}/{Dv} above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if q_positions.shape[0] != Sq or kv_positions.shape[0] != Skv:
        raise ValueError("positions must be [Sq] and [Skv]")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap must be positive, got {logit_cap}")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.flash_attention_launch(
        p(q), p(k), p(v), p(q_positions), p(kv_positions), p(out), B, Sq,
        Skv, H, KH, D, Dv, int(causal), 0 if window is None else int(window),
        _DTYPES[q.dtype], 0.0 if logit_cap is None else float(logit_cap),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention_launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
