"""Attention kernels of the model path: the CUDA kernels' launch wrapper and
their plain PyTorch versions.

  * ``flash_attention_cuda`` -- online-softmax attention with GQA folding,
    causal masking by positions, a sliding window and a tanh logit cap;
    float32 accumulation over float32 or bfloat16 inputs.  Replaces
    ``flash_attention_tpu`` (src/repro/kernels/flash_attention.py:81) and
    serves every attention call of the port's model.  It launches one of
    three kernels, chosen by ``choose_kernel`` from (dtype, D, Dv, Sq * G):
      - ``split_kv`` (``csrc/flash_attention_decode.cu``): at most
        ``SPLIT_KV_MAX_ROWS`` rows per (batch, kv head) -- decode against
        the cache; the kv axis split into 64-slot chunks across blocks,
        then a combine pass;
      - ``wgmma`` (``csrc/flash_attention_wgmma.cu``): bfloat16 with D
        and Dv multiples of ``WGMMA_DIM_STEP`` (8), D <= ``WGMMA_MAX_D``
        (192) and Dv <= ``WGMMA_MAX_DV`` (128) -- every bfloat16 prefill
        of the repo's configurations: 32, (48, 32), 64, 120, 128 and
        MLA's (192, 128) -- on the tensor cores, K/V through a TMA ring,
        a head dim that is not a multiple of 64 in zero-padded boxes;
      - ``simt`` (``csrc/flash_attention.cu``): what is left, on the CUDA
        cores: float32 prefill (the float32 checks; no serving or
        training path runs float32 attention) and bfloat16 pairs outside
        the wgmma rule (D or Dv not a multiple of 8, D > 192, Dv >
        128), and any call forced onto it.
  * ``flash_attention`` (chunked online softmax) and ``direct_attention``
    (one pass over all slots, for short q) -- the plain versions, line for
    line the reference's ``models/layers.py`` functions; ``attention_plain``
    chooses between them as the reference's ``attend`` does.
  * ``tensor_core_attention_plain`` and ``split_kv_attention_plain`` -- the
    plain versions of the wgmma and split-KV kernels' own arithmetic (P
    rounded to the input dtype before P . V; per-chunk partials and their
    log-sum-exp combine).
  * ``attend_lse`` -- the split-KV kernel with its optional output, each
    row's log-sum-exp [B, H, Sq] (float32, -inf where nothing is
    unmasked), beside the attention: sharded serving's ranks each attend
    their block of the cache and combine by it (``models/layers.py``).

``attend`` makes either differentiable: an autograd ``Function`` whose
forward is the kernel on CUDA tensors (its plain version on CPU tensors)
and whose backward is ``flash_attention_backward``, the reference's
chunked flash backward (``src/repro/models/layers.py:231-318``) in plain
PyTorch, the same on both devices.  The reference's backward is plain JAX,
so no TPU kernel stands behind it.

Layout ``[B, S, heads, D]``; query head h reads kv head ``h // G``.  The
positions decide the mask: a kv slot with a negative position is masked
(padding, or an unwritten ring-buffer cache slot), and with ``causal`` a
pair needs ``0 <= q_pos - kv_pos < window``.  A row with no unmasked slot
gives 0.  The wrapper launches the kernel for CUDA tensors and raises on
what the kernels do not take; ``models.layers.attend`` and
``kernels.ops.flash_attention`` pick the plain version only for tensors on
the CPU.  On the ``meta`` device (the dry run, ``launch/roofline.py``)
neither runs: ``meta_attention`` returns the kernel's output shape and
bills the tracer in ``META_TRACE`` the FLOPs of the tiles the chosen
kernel computes (``kernel_flops``, from the positions' values, which the
tracer knows) and the bytes of its inputs and output; with no tracer it
raises.  ``LAUNCHES["flash_attention"]`` counts wrapper calls that
launched a kernel, ``LAUNCHES["flash_attention_<kernel>"]`` each kernel's
share of them, and ``LAUNCHES["flash_attention_split_kv_lse"]`` the
split-KV launches that wrote the lse output; each hook in
``LAUNCH_HOOKS`` is called with every name a launch counts.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from . import _build

KERNELS = ("wgmma", "split_kv", "simt")
# kernel launches since the last reset: all, and per kernel
LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                            **{f"flash_attention_{n}": 0 for n in KERNELS},
                            "flash_attention_split_kv_lse": 0}
# callables hook(counter name), called at every count LAUNCHES takes
# (two a launch: "flash_attention" and the kernel's own; a third,
# "flash_attention_split_kv_lse", for a split-KV launch with lse)
LAUNCH_HOOKS: List = []
# the split-KV kernel takes calls of at most this many rows (Sq * G) per
# (batch, kv head) (csrc/flash_attention_decode.cu: kMaxRows)
SPLIT_KV_MAX_ROWS = 16
# kv slots per chunk of the split-KV kernel (csrc/flash_attention_decode.cu:
# kChunk); a split is a few chunks, sized for about SPLIT_KV_TARGET_BLOCKS
# blocks, at most SPLIT_KV_MAX_CHUNKS chunks
SPLIT_KV_CHUNK = 64
SPLIT_KV_TARGET_BLOCKS = 512
SPLIT_KV_MAX_CHUNKS = 16
# kv slots per tile of the wgmma kernel (csrc/flash_attention_wgmma.cu:
# kSlots) and the head dims it takes: D and Dv multiples of 8 (a row of a
# whole number of 16-byte TMA strides), D <= 192 (three 64-column boxes:
# MLA's prefill, K of 128 + 64 rope dims) and Dv <= 128 (two boxes: the
# output accumulator's registers)
WGMMA_KV_TILE = 64
WGMMA_DIM_STEP = 8
WGMMA_MAX_D = 192
WGMMA_MAX_DV = 128
# Q sequence lengths up to this use the direct (unchunked) plain path
DECODE_DIRECT_MAX_Q = 8
# kv chunk of the chunked plain path when ``attention_plain`` dispatches to
# it, and of the backward (the reference's ``attend`` default)
PLAIN_KV_CHUNK = 512
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# query rows a block of the wgmma kernel (csrc/flash_attention_wgmma.cu:
# kRows) and of the SIMT kernel (csrc/flash_attention.cu: kRows) owns, kv
# slots a tile of the SIMT kernel (kSlots), and the wgmma kernel's box of
# head-dim columns (a head dim rides in whole 64-column boxes)
WGMMA_ROWS = 128
SIMT_ROWS = 64
SIMT_KV_TILE = 64
WGMMA_BOX = 64
# the wgmma kernel's K/V ring depth (kStages), the split-KV kernel's
# threads a block (kThreads), and the shared memory a block may opt into
# on the H100 (the split-KV kernel's kMaxSmem)
WGMMA_STAGES = 3
SPLIT_KV_THREADS = 128
SMEM_PER_BLOCK = 232448
# the distinct shapes that set a launch's shared memory, since import:
# ("wgmma", D, Dv, Skv, softcap?), ("split_kv", D, Dv, dtype, rows, cps),
# ("simt", D, Dv, dtype); dtype 0 float32, 1 bfloat16
LAUNCH_SHAPES: Set[tuple] = set()
# the dry run's tracer (``launch.roofline``) while it counts a step on the
# meta device: ``positions(t)`` gives a positions tensor's values,
# ``kernel(name, flops, bytes_read, bytes_written)`` bills a launch
META_TRACE = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    LAUNCHES[name] += 1
    if LAUNCH_HOOKS:
        for hook in list(LAUNCH_HOOKS):
            hook(name)


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

def _online_softmax(qg, k, v, q_positions, kv_positions, causal, window,
                    logit_cap, kv_chunk: int, p_dtype) -> torch.Tensor:
    """Online softmax over kv chunks: qg [B, Sq, KH, G, D] float32, already
    scaled -> [B, Sq, KH, G, Dv] float32.  P is rounded to ``p_dtype``
    before P . V; the row sums take it unrounded."""
    B, Sq, KH, G, _ = qg.shape
    Skv, Dv = k.shape[1], v.shape[-1]
    dev = qg.device
    neg_inf = torch.tensor(-math.inf, device=dev)
    m = torch.full((B, Sq, KH, G), -math.inf, device=dev)
    l = torch.zeros((B, Sq, KH, G), device=dev)
    acc = torch.zeros((B, Sq, KH, G, Dv), device=dev)
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
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgc,bchv->bqhgv", p.to(p_dtype).float(), vj)
        m = m_new
    return acc / torch.clamp_min(l, 1e-20)[..., None]


def flash_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                    window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over kv chunks (the reference's
    ``layers.flash_attention``): q [B, Sq, H, D], k/v [B, Skv, KH, D(v)]
    -> [B, Sq, H, Dv] float32.  q is scaled in its own dtype, then cast."""
    B, Sq, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[-1]
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, Sq, KH, H // KH, D).float()
    out = _online_softmax(qg, k, v, q_positions, kv_positions, causal,
                          window, logit_cap, kv_chunk, torch.float32)
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


def tensor_core_attention_plain(q, k, v, *, q_positions, kv_positions,
                                causal=True, window: Optional[int] = None,
                                logit_cap: Optional[float] = None
                                ) -> torch.Tensor:
    """The wgmma kernel's arithmetic (``csrc/flash_attention_wgmma.cu``):
    online softmax over ``WGMMA_KV_TILE``-slot tiles, q cast to float32
    and scaled, P rounded to q's dtype (bfloat16 on the kernel's path)
    before P . V, the row sums of the unrounded P.  -> float32."""
    B, Sq, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[-1]
    qg = (q.float() / math.sqrt(D)).reshape(B, Sq, KH, H // KH, D)
    out = _online_softmax(qg, k, v, q_positions, kv_positions, causal,
                          window, logit_cap, WGMMA_KV_TILE, q.dtype)
    return out.reshape(B, Sq, H, Dv)


def split_kv_chunks_per_split(B: int, KH: int, Skv: int) -> int:
    """Chunks of ``SPLIT_KV_CHUNK`` slots in one split of the split-KV
    kernel: enough splits for about ``SPLIT_KV_TARGET_BLOCKS`` blocks of
    (split, kv head, batch), at most one per chunk, at most
    ``SPLIT_KV_MAX_CHUNKS`` chunks each."""
    chunks = max(1, -(-Skv // SPLIT_KV_CHUNK))
    splits = min(chunks, -(-SPLIT_KV_TARGET_BLOCKS // (B * KH)))
    return min(-(-chunks // splits), SPLIT_KV_MAX_CHUNKS)


def split_kv_attention_plain(q, k, v, *, q_positions, kv_positions,
                             causal=True, window: Optional[int] = None,
                             logit_cap: Optional[float] = None,
                             return_lse: bool = False):
    """The split-KV kernel's arithmetic (``csrc/flash_attention_decode.cu``):
    per split (``split_kv_chunks_per_split`` chunks of ``SPLIT_KV_CHUNK``
    slots) the partials (m, l, acc) of each row (m = -inf, l = 0 where the
    split has no unmasked slot), then out = sum_s e^(m_s - M) acc_s /
    sum_s e^(m_s - M) l_s, 0 for a row with no unmasked slot at all.
    -> float32; with ``return_lse`` (out, lse [B, H, Sq] float32): M +
    log(sum_s e^(m_s - M) l_s), -inf for a row with no unmasked slot."""
    B, Sq, H, D = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    if Skv == 0:
        out = torch.zeros((B, Sq, H, Dv), device=q.device)
        return (out, torch.full((B, H, Sq), -math.inf, device=q.device)) \
            if return_lse else out
    qg = (q.float() / math.sqrt(D)).reshape(B, Sq, KH, G, D)
    neg_inf = torch.tensor(-math.inf, device=q.device)
    ms, ls, accs = [], [], []
    width = SPLIT_KV_CHUNK * split_kv_chunks_per_split(B, KH, Skv)
    for c0 in range(0, Skv, width):
        kj = k[:, c0:c0 + width].float()
        vj = v[:, c0:c0 + width].float()
        pj = kv_positions[c0:c0 + width]
        s = softcap(torch.einsum("bqhgd,bchd->bqhgc", qg, kj), logit_cap)
        mask = _mask(q_positions, pj, causal, window)
        s = torch.where(mask, s, neg_inf)
        m = s.amax(-1)
        m_safe = torch.where(torch.isneginf(m), 0.0, m)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bqhgc,bchv->bqhgv", p, vj))
    m = torch.stack(ms)
    M = m.amax(0)
    w = torch.exp(m - torch.where(torch.isneginf(M), 0.0, M))
    L = (w * torch.stack(ls)).sum(0)
    acc = (w[..., None] * torch.stack(accs)).sum(0)
    out = acc / torch.clamp_min(L, 1e-20)[..., None]
    out = out.reshape(B, Sq, H, Dv)
    if not return_lse:
        return out
    lse = torch.where(torch.isneginf(M), -math.inf, M + torch.log(L))
    return out, lse.reshape(B, Sq, H).transpose(1, 2).contiguous()


def simt_launch_smem(D: int, Dv: int) -> int:
    """Dynamic shared memory ``csrc/flash_attention.cu`` requests at head
    dims D, Dv (its ``smem_bytes``): Q and a K tile of
    ``SIMT_ROWS`` / ``SIMT_KV_TILE`` rows of QS floats (D rounded up to 4,
    plus 4 where that is a multiple of 8), a V tile, the scores
    [rows, tile + 1], two row vectors, and the int positions."""
    Dp, Dvp = (D + 3) & ~3, (Dv + 3) & ~3
    QS = Dp + 4 if Dp % 8 == 0 else Dp
    floats = (SIMT_ROWS * QS + SIMT_KV_TILE * QS + SIMT_KV_TILE * Dvp
              + SIMT_ROWS * (SIMT_KV_TILE + 1) + 2 * SIMT_ROWS)
    return floats * 4 + (SIMT_ROWS + SIMT_KV_TILE) * 4


def split_kv_smem_bytes(D: int, Dv: int, esz: int, rows: int, cps: int,
                        nbuf: int) -> int:
    """Dynamic shared memory of the split-KV kernel
    (``csrc/flash_attention_decode.cu``: ``smem_bytes``) with ``nbuf``
    K/V chunk buffers: K rows padded to an odd number of 16-byte units,
    V rows, then float32 Q, scores, partial sums and int bookkeeping;
    ``esz`` bytes an element, ``rows`` = Sq * G, ``cps`` chunks a
    split."""
    units = (D * esz + 15) // 16
    k_stride = 16 * (units if units % 2 else units + 1)
    RP = (rows + 3) & ~3
    parts = SPLIT_KV_THREADS // (Dv // 2)
    return (nbuf * SPLIT_KV_CHUNK * (k_stride + Dv * esz)
            + 4 * (rows * D + rows * SPLIT_KV_CHUNK + SPLIT_KV_CHUNK * RP
                   + parts * RP * Dv + 3 * RP)
            + 4 * (cps * SPLIT_KV_CHUNK + rows + cps + 1))


def split_kv_launch_smem(D: int, Dv: int, esz: int, rows: int,
                         cps: int) -> int:
    """What the split-KV launcher requests: two K/V buffers (the next
    chunk lands during this one's math) where they fit
    ``SMEM_PER_BLOCK``, else one (its ``nbuf_for``)."""
    two = split_kv_smem_bytes(D, Dv, esz, rows, cps, 2)
    if two <= SMEM_PER_BLOCK:
        return two
    return split_kv_smem_bytes(D, Dv, esz, rows, cps, 1)


def wgmma_launch_smem(D: int, Dv: int, Skv: int) -> int:
    """Dynamic shared memory ``csrc/flash_attention_wgmma.cu`` requests
    (its ``smem_bytes``): 1024 bytes of alignment, the Q boxes
    (``WGMMA_ROWS`` rows of 128 bytes each box), the K/V ring of
    ``WGMMA_STAGES`` stages of ``WGMMA_KV_TILE``-row boxes, the barriers,
    and the live-tile count, flags and list (two ints a kv tile)."""
    nch, ncv = -(-D // WGMMA_BOX), -(-Dv // WGMMA_BOX)
    n_tiles = -(-Skv // WGMMA_KV_TILE)
    return (1024 + nch * WGMMA_ROWS * 128
            + WGMMA_STAGES * (nch + ncv) * WGMMA_KV_TILE * 128
            + 8 * (1 + 2 * WGMMA_STAGES) + 4 * (4 + 2 * n_tiles))


def _takes(kernel: str, dtype, D: int, Dv: int, rows: int) -> bool:
    """Whether ``kernel`` takes a call of these inputs (rows = Sq * G per
    (batch, kv head)); D, Dv <= MAX_HEAD_DIM is checked before."""
    if kernel == "split_kv":
        return (rows <= SPLIT_KV_MAX_ROWS and (D * dtype.itemsize) % 16 == 0
                and (Dv * dtype.itemsize) % 16 == 0)
    if kernel == "wgmma":
        return (dtype == torch.bfloat16 and 0 < D <= WGMMA_MAX_D
                and 0 < Dv <= WGMMA_MAX_DV and D % WGMMA_DIM_STEP == 0
                and Dv % WGMMA_DIM_STEP == 0)
    if kernel == "simt":
        return True
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


def choose_kernel(dtype, D: int, Dv: int, rows: int) -> str:
    """The kernel ``flash_attention_cuda`` launches: ``split_kv`` for at
    most ``SPLIT_KV_MAX_ROWS`` rows per (batch, kv head) with 16-byte K/V
    rows, else ``wgmma`` for bfloat16 with D and Dv multiples of 8, D <=
    192 and Dv <= 128, else ``simt``."""
    if _takes("split_kv", dtype, D, Dv, rows):
        return "split_kv"
    if _takes("wgmma", dtype, D, Dv, rows):
        return "wgmma"
    return "simt"


# ---------------------------------------------------------------------------
# The kernels' work, counted (the dry run)
# ---------------------------------------------------------------------------

def _live_tiles(lo: np.ndarray, hi: np.ndarray, kv_pos: np.ndarray,
                tile: int, causal: bool, window: Optional[int]
                ) -> np.ndarray:
    """[blocks, tiles] bool: whether each ``tile``-slot kv tile holds a slot
    some row of each block may attend, the wgmma and SIMT kernels' test --
    position >= 0 and, with ``causal``, inside (lo - window, hi] for the
    block's query positions lo..hi."""
    n_tiles = -(-kv_pos.size // tile)
    pos = np.full(n_tiles * tile, -1, dtype=np.int64)
    pos[:kv_pos.size] = kv_pos
    pos = pos.reshape(n_tiles, tile)
    if not causal:
        return np.broadcast_to((pos >= 0).any(1), (lo.size, n_tiles))
    srt = np.sort(np.where(pos >= 0, pos, np.iinfo(np.int64).max), 1)
    below = np.maximum(lo - window, -1) if window else np.full_like(lo, -1)
    return np.stack([np.searchsorted(row, hi, "right")
                     > np.searchsorted(row, below, "right")
                     for row in srt], 1)


@functools.lru_cache(maxsize=256)
def _kernel_flops(kernel: str, B: int, H: int, KH: int, D: int, Dv: int,
                  q_pos: bytes, kv_pos: bytes, causal: bool,
                  window: Optional[int]) -> float:
    qp = np.frombuffer(q_pos, dtype=np.int32).astype(np.int64)
    kp = np.frombuffer(kv_pos, dtype=np.int32).astype(np.int64)
    G, Sq = H // KH, qp.size
    if kernel == "split_kv":
        rows = Sq * G
        n_chunks = -(-kp.size // SPLIT_KV_CHUNK)
        pos = np.full(n_chunks * SPLIT_KV_CHUNK, -1, dtype=np.int64)
        pos[:kp.size] = kp
        pos = pos.reshape(n_chunks, SPLIT_KV_CHUNK, 1)
        ok = pos >= 0
        if causal:
            rel = qp[None, None, :] - pos
            ok = ok & (rel >= 0) & ((rel < window) if window else True)
        live = int(ok.any((1, 2)).sum())
        return 2.0 * B * KH * live * rows * SPLIT_KV_CHUNK * (D + Dv)
    if kernel == "wgmma":
        gb = min(G, WGMMA_ROWS)
        per, head_tiles = WGMMA_ROWS // gb, -(-G // gb)
        starts = np.arange(0, Sq, per)
        lo = np.minimum.reduceat(qp, starts)
        hi = np.maximum.reduceat(qp, starts)
        live = int(_live_tiles(lo, hi, kp, WGMMA_KV_TILE, causal,
                               window).sum())
        dims = WGMMA_BOX * (-(-D // WGMMA_BOX) + -(-Dv // WGMMA_BOX))
        return (2.0 * B * KH * head_tiles * live * WGMMA_ROWS
                * WGMMA_KV_TILE * dims)
    # simt: blocks of SIMT_ROWS (position, head) rows, position-major
    starts = np.arange(0, Sq * G, SIMT_ROWS) // G
    ends = np.minimum(np.arange(SIMT_ROWS, Sq * G + SIMT_ROWS, SIMT_ROWS),
                      Sq * G) - 1
    ends = ends // G
    lo = np.array([qp[a:b + 1].min() for a, b in zip(starts, ends)])
    hi = np.array([qp[a:b + 1].max() for a, b in zip(starts, ends)])
    live = int(_live_tiles(lo, hi, kp, SIMT_KV_TILE, causal, window).sum())
    return 2.0 * B * KH * live * SIMT_ROWS * SIMT_KV_TILE * (D + Dv)


def kernel_flops(kernel: str, B: int, H: int, KH: int, D: int, Dv: int,
                 q_positions, kv_positions, causal: bool = True,
                 window: Optional[int] = None) -> float:
    """FLOPs the kernel ``kernel`` does for one call: 2 (D + Dv) a (row,
    slot) pair of every tile it computes, by its own tiling and tile
    skipping --
      * ``wgmma``: blocks of ``WGMMA_ROWS`` (position, head) rows of a kv
        head (padding rows computed), each kv tile of ``WGMMA_KV_TILE``
        slots that ``_live_tiles`` keeps, head dims in whole 64-column
        boxes (D 120 runs D 128's products);
      * ``simt``: blocks of ``SIMT_ROWS`` rows, ``SIMT_KV_TILE``-slot tiles
        the same test keeps;
      * ``split_kv``: every row of a (batch, kv head) against each
        ``SPLIT_KV_CHUNK``-slot chunk that holds an unmasked (row, slot)
        pair.
    Positions: host int32 tensors or arrays [Sq] and [Skv]."""
    as_bytes = lambda p: np.ascontiguousarray(
        np.asarray(p), dtype=np.int32).tobytes()
    return _kernel_flops(kernel, B, H, KH, D, Dv, as_bytes(q_positions),
                         as_bytes(kv_positions), bool(causal),
                         None if window is None else int(window))


def meta_attention(q, k, v, q_positions, kv_positions, *, causal=True,
                   window: Optional[int] = None, return_lse: bool = False):
    """The kernel's call on ``meta`` tensors: bills ``META_TRACE`` the
    chosen kernel's FLOPs (``kernel_flops``, over the positions' values
    the tracer holds), the bytes of q, k, v and both positions read and of
    the output written (no temporaries), and returns the output [B, Sq,
    H, Dv] in q's dtype, as ``flash_attention_cuda`` does (with
    ``return_lse``: the split-KV kernel's, and its lse [B, H, Sq]
    float32)."""
    trace = META_TRACE
    if trace is None:
        raise RuntimeError("attention on the meta device runs only under "
                           "launch.roofline.analyze_step, which knows the "
                           "positions")
    B, Sq, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[-1]
    name = "split_kv" if return_lse else choose_kernel(q.dtype, D, Dv,
                                                       Sq * (H // KH))
    flops = kernel_flops(name, B, H, KH, D, Dv,
                         trace.positions(q_positions).numpy(),
                         trace.positions(kv_positions).numpy(), causal,
                         window)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    outs = [out]
    if return_lse:
        outs.append(torch.empty((B, H, Sq), device=q.device))
    n_read = sum(t.numel() * t.element_size()
                 for t in (q, k, v, q_positions, kv_positions))
    trace.kernel(f"flash_attention_{name}", flops, n_read,
                 sum(t.numel() * t.element_size() for t in outs))
    return tuple(outs) if return_lse else out


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
                         logit_cap: Optional[float] = None,
                         kernel: Optional[str] = None,
                         return_lse: bool = False):
    """Launch a flash-attention kernel: q [B, Sq, H, D], k [B, Skv, KH, D],
    v [B, Skv, KH, Dv] (float32 or bfloat16, one dtype), q_positions [Sq]
    and kv_positions [Skv] int32 -> [B, Sq, H, Dv] in q's dtype.  D, Dv <=
    256.  ``kernel`` (one of ``KERNELS``) overrides ``choose_kernel``, and
    raises if that kernel does not take the inputs.  ``return_lse``: the
    split-KV kernel (raises if it does not take the inputs, or another
    ``kernel`` is named) with its lse output -> (out, lse [B, H, Sq]
    float32, -inf for a row with no unmasked slot)."""
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
    rows = Sq * (H // KH)
    if return_lse and kernel not in (None, "split_kv"):
        raise ValueError(f"return_lse is the split_kv kernel's, not the "
                         f"{kernel} kernel's")
    name = "split_kv" if return_lse else kernel or choose_kernel(
        q.dtype, D, Dv, rows)
    if not _takes(name, q.dtype, D, Dv, rows):
        raise ValueError(f"the {name} kernel does not take {q.dtype} at "
                         f"D {D}, Dv {Dv}, {rows} rows per kv head")
    if name != "simt" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"the {name} kernel needs 16-byte aligned q, k, v")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, Sq), device=dev) if return_lse else None
    if out.numel() == 0 or (return_lse and Skv == 0):
        # nothing to attend: every row 0, its lse -inf
        return (out.zero_(), lse.fill_(-math.inf)) if return_lse else out
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    ptrs = (p(q), p(k), p(v), p(q_positions), p(kv_positions), p(out))
    win = 0 if window is None else int(window)
    cap = 0.0 if logit_cap is None else float(logit_cap)
    dt = _DTYPES[q.dtype]
    if name == "wgmma":
        LAUNCH_SHAPES.add((name, D, Dv, Skv, logit_cap is not None))
        err = _build.library("flash_attention_wgmma") \
            .flash_attention_wgmma_launch(*ptrs, B, Sq, Skv, H, KH, D, Dv,
                                          int(causal), win, cap, stream)
    elif name == "split_kv":
        cps = split_kv_chunks_per_split(B, KH, Skv)
        LAUNCH_SHAPES.add((name, D, Dv, dt, rows, cps))
        splits = -(-Skv // (SPLIT_KV_CHUNK * cps))
        ml = torch.empty((B, KH, splits, rows, 2), device=dev)
        acc = torch.empty((B, KH, splits, rows, Dv), device=dev)
        lse_ptr = p(lse) if return_lse else ctypes.c_void_p(None)
        err = _build.library("flash_attention_decode") \
            .flash_attention_decode_launch(*ptrs, p(ml), p(acc), lse_ptr, B,
                                           Sq, Skv, H, KH, D, Dv, int(causal),
                                           win, dt, cps, cap, stream)
    else:
        LAUNCH_SHAPES.add((name, D, Dv, dt))
        err = _build.library("flash_attention").flash_attention_launch(
            *ptrs, B, Sq, Skv, H, KH, D, Dv, int(causal), win, dt, cap,
            stream)
    if err != 0:
        raise RuntimeError(f"flash attention ({name}) launch failed: error "
                           f"{err}")
    _count_launch("flash_attention")
    _count_launch(f"flash_attention_{name}")
    if return_lse:
        _count_launch("flash_attention_split_kv_lse")
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# Differentiable attention: the kernel's forward, the reference's backward
# ---------------------------------------------------------------------------

def flash_attention_backward(q, k, v, q_positions, kv_positions, out, do, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             logit_cap: Optional[float] = None,
                             kv_chunk: int = PLAIN_KV_CHUNK):
    """(dq, dk, dv) of attention, given its output ``out`` and the output's
    gradient ``do``: the reference's ``_flash_bwd``, in float32, in the
    inputs' dtypes at the end.  One pass over kv chunks of ``kv_chunk``
    slots recomputes each row's log-sum-exp; a second recomputes P = exp(s
    - lse) chunk by chunk and takes dv, dp, ds = P (dp - delta) (times the
    softcap's derivative 1 - tanh^2(s / cap)), dk per chunk and dq summed
    over chunks.  No probability tensor outlives its chunk.  GQA is folded
    as rows [B, KH, Sq * G]; a row with no unmasked slot gets zero
    gradients (P is 0 there, never exp of -inf minus -inf).

    A chunk is computed only over the rows from the first to the last that
    its mask leaves a slot (one host read of those bounds a call): the
    rows outside take exactly 0 from it, so the result is the reference's,
    and a causal call does about half the work (a window, less)."""
    B, Sq, H, D = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    R = Sq * G
    scale = 1.0 / math.sqrt(D)

    def rows(t, d):                         # [B, Sq, H, d] -> [B, KH, R, d]
        return t.float().reshape(B, Sq, KH, G, d).permute(0, 2, 1, 3, 4) \
            .reshape(B, KH, R, d)

    qg = rows(q, D) * scale
    dog = rows(do, Dv)
    delta = (rows(out, Dv) * dog).sum(-1)                    # [B, KH, R]
    kh = k.float().permute(0, 2, 1, 3)                       # [B, KH, Skv, D]
    vh = v.float().permute(0, 2, 1, 3)
    q_rows = q_positions.repeat_interleave(G)   # a row's query position
    chunks = [(c0, min(c0 + kv_chunk, Skv)) for c0 in range(0, Skv, kv_chunk)]
    masks = [_mask(q_rows, kv_positions[c0:c1], causal, window)[0, :, 0, 0]
             for c0, c1 in chunks]                      # [R, C] each
    if q.is_meta:
        # no values on meta: the bounds from the positions' host values,
        # which the dry run's tracer holds (``META_TRACE``)
        if META_TRACE is None:
            raise RuntimeError("the attention backward on the meta device "
                               "runs only under launch.roofline."
                               "analyze_step")
        bounds = live_row_bounds(META_TRACE.positions(q_positions).numpy(),
                                 META_TRACE.positions(kv_positions).numpy(),
                                 chunks, G, causal, window)
    else:
        live = torch.stack([mk.any(1) for mk in masks]).int()  # [chunks, R]
        bounds = torch.stack([live.amax(1), live.argmax(1),
                              R - live.flip(1).argmax(1)], 1).tolist()
    chunks = [(c0, c1, r0, r1, mk[r0:r1])
              for (c0, c1), mk, (any_row, r0, r1) in zip(chunks, masks, bounds)
              if any_row]

    # pass 1: the exact log-sum-exp of every row
    m = torch.full((B, KH, R), -math.inf, device=q.device)
    l = torch.zeros((B, KH, R), device=q.device)
    for c0, c1, r0, r1, mask in chunks:
        s = softcap(qg[:, :, r0:r1] @ kh[:, :, c0:c1].mT, logit_cap)
        s = s.masked_fill_(~mask, -math.inf)
        m_old = m[:, :, r0:r1]
        m_new = torch.maximum(m_old, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        corr = torch.exp(torch.where(torch.isneginf(m_old), 0.0, m_old)
                         - m_safe)
        corr = torch.where(torch.isneginf(m_old), 0.0, corr)
        p = s.sub_(m_safe[..., None]).exp_().masked_fill_(~mask, 0.0)
        l[:, :, r0:r1] = l[:, :, r0:r1] * corr + p.sum(-1)
        m[:, :, r0:r1] = m_new
    lse = torch.where(torch.isneginf(m), 0.0, m) \
        + torch.log(torch.clamp_min(l, 1e-20))

    # pass 2: dq accumulated over chunks, dk and dv a chunk at a time
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    for c0, c1, r0, r1, mask in chunks:
        qj, doj = qg[:, :, r0:r1], dog[:, :, r0:r1]
        kj, vj = kh[:, :, c0:c1], vh[:, :, c0:c1]
        s = qj @ kj.mT                                         # [B, KH, r, C]
        th = None if logit_cap is None else torch.tanh(s / logit_cap)
        sc = s if th is None else logit_cap * th
        p = sc.sub_(lse[:, :, r0:r1, None]).exp_().masked_fill_(~mask, 0.0)
        dv[:, :, c0:c1] = p.mT @ doj
        ds = (doj @ vj.mT).sub_(delta[:, :, r0:r1, None]).mul_(p)
        if th is not None:                       # d softcap = 1 - tanh^2
            ds = ds.mul_(1.0 - th * th)
        dq[:, :, r0:r1] += ds @ kj
        dk[:, :, c0:c1] = ds.mT @ qj
    dq = (dq * scale).reshape(B, KH, Sq, G, D).permute(0, 2, 1, 3, 4) \
        .reshape(B, Sq, H, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def live_row_bounds(q_positions, kv_positions, chunks, G: int, causal: bool,
                    window: Optional[int]) -> List[List[int]]:
    """Per kv chunk (c0, c1): [any, r0, r1] -- whether some row attends a
    slot of the chunk, and the first and one past the last such row (rows
    position-major, G a position) -- from host positions (numpy), as
    ``flash_attention_backward`` takes them from its masks: a row of query
    position q attends a slot of position p >= 0 with, when ``causal``,
    0 <= q - p (< window)."""
    q_rows = np.repeat(np.asarray(q_positions, dtype=np.int64), G)
    kv = np.asarray(kv_positions, dtype=np.int64)
    out = []
    for c0, c1 in chunks:
        srt = np.sort(kv[c0:c1][kv[c0:c1] >= 0])
        if not causal:
            live = np.full(q_rows.size, srt.size > 0)
        else:
            lo = q_rows - window if window else np.full_like(q_rows, -1)
            live = (np.searchsorted(srt, q_rows, "right")
                    > np.searchsorted(srt, lo, "right"))
        idx = np.flatnonzero(live)
        out.append([1, int(idx[0]), int(idx[-1]) + 1] if idx.size
                   else [0, 0, q_rows.size])
    return out


def _attention_forward(q, k, v, q_positions, kv_positions, causal, window,
                       logit_cap, plain):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, q_positions, kv_positions,
                                    causal=causal, window=window,
                                    logit_cap=logit_cap)
    if q.is_meta:
        return meta_attention(q, k, v, q_positions, kv_positions,
                              causal=causal, window=window)
    return plain(q, k, v, q_positions=q_positions, kv_positions=kv_positions,
                 causal=causal, window=window, logit_cap=logit_cap)


def attend_lse(q, k, v, q_positions, kv_positions, *, causal: bool = True,
               window: Optional[int] = None,
               logit_cap: Optional[float] = None):
    """(out [B, Sq, H, Dv], lse [B, H, Sq] float32) of attention over the
    given kv slots: on CUDA tensors the split-KV kernel with its lse output
    (``flash_attention_cuda(..., return_lse=True)``; out in q's dtype; it
    raises where the kernel does not take the call), on CPU tensors its
    plain version (``split_kv_attention_plain``, float32), on meta tensors
    the kernel's count.  Serving only: no gradient."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, q_positions, kv_positions,
                                    causal=causal, window=window,
                                    logit_cap=logit_cap, return_lse=True)
    if q.is_meta:
        return meta_attention(q, k, v, q_positions, kv_positions,
                              causal=causal, window=window, return_lse=True)
    return split_kv_attention_plain(q, k, v, q_positions=q_positions,
                                    kv_positions=kv_positions, causal=causal,
                                    window=window, logit_cap=logit_cap,
                                    return_lse=True)


class FlashAttention(torch.autograd.Function):
    """Attention with the kernel's forward and the reference's backward.
    Saves q, k, v, both position vectors and the output; no probability
    tensor."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window,
                logit_cap, plain):
        out = _attention_forward(q, k, v, q_positions, kv_positions, causal,
                                 window, logit_cap, plain)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, out)
        ctx.opts = dict(causal=causal, window=window, logit_cap=logit_cap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_positions, kv_positions, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, q_positions,
                                              kv_positions, out, do,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def attend(q, k, v, q_positions, kv_positions, *, causal: bool = True,
           window: Optional[int] = None, logit_cap: Optional[float] = None,
           plain=attention_plain) -> torch.Tensor:
    """Attention through the kernel on CUDA tensors (``flash_attention_cuda``,
    output in q's dtype), through ``plain`` on CPU tensors (float32
    output), and on meta tensors the kernel's count (``meta_attention``,
    the dry run's).  Under grad with an input that requires it, the call goes
    through ``FlashAttention``, so the output always has a ``grad_fn``;
    otherwise (serving, under ``torch.no_grad``) it is the bare forward."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_positions, kv_positions,
                                    causal, window, logit_cap, plain)
    return _attention_forward(q, k, v, q_positions, kv_positions, causal,
                              window, logit_cap, plain)
