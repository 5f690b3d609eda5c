"""Decode-state (KV cache / recurrent state) specifications of the port
(the reference's ``serve/cache.py``).

Caches mirror the layer plan: a list with one entry per layer group, each a
dict ``{"b{j}": leaves}`` whose leaves carry the group's ``repeats`` axis
first.  Leaves are ``TSpec``s (shape, dtype; the reference's logical
sharding axes have no use on one device); ``zeros`` turns a spec tree into
torch tensors on a device.

Sizing: a full-attention layer holds ``Smax = max_len`` slots, a
sliding-window layer ``min(window, max_len)`` (a ring buffer).  An MLA
layer holds the compressed KV (``kv_lora_rank + rope_head_dim`` values a
token) in place of per-head K and V.  mLSTM, sLSTM and mamba states are
O(1) in the sequence length and float32 (hymba's cache is its attention
K/V beside its mamba state).  Whisper's decoder layer holds its
self-attention K/V beside a cross cache of the encoder's projected K/V,
``enc_len`` slots, written once at prefill.  The KV cache dtype must be
the model's activation dtype: the port writes the cache in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from ..core.power import Device, resolve_device
from ..models.config import ArchConfig
from ..models.model import HYBRID_KINDS, block_window, layer_plan
from ..models.tree import leaves, tmap


@dataclass(frozen=True)
class TSpec:
    shape: Tuple[int, ...]
    dtype: Any


def zeros(tree, device: Device = None):
    """Tensors for a spec tree on ``device`` (default CUDA): zeros, and
    position ids filled with -1 (unwritten)."""
    dev = resolve_device(device)

    def one(s: TSpec):
        if s.dtype == torch.int32:
            return torch.full(s.shape, -1, dtype=torch.int32, device=dev)
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)
    return tmap(one, tree)


def _attn_spec(cfg: ArchConfig, B: int, smax: int, dtype) -> Dict:
    KH, Dh = cfg.n_kv_heads, cfg.head_dim
    return dict(k=TSpec((B, smax, KH, Dh), dtype),
                v=TSpec((B, smax, KH, Dh), dtype),
                pos_ids=TSpec((smax,), torch.int32))


def _mla_spec(cfg: ArchConfig, B: int, smax: int, dtype) -> Dict:
    return dict(c_kv=TSpec((B, smax, cfg.kv_lora_rank), dtype),
                k_rope=TSpec((B, smax, cfg.rope_head_dim), dtype),
                pos_ids=TSpec((smax,), torch.int32))


def _mlstm_spec(cfg: ArchConfig, B: int) -> Dict:
    Din = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    dqk, dv = Din // H // 2, Din // H
    f32 = torch.float32
    return dict(conv=TSpec((B, cfg.conv_kernel - 1, Din), f32),
                cell=(TSpec((B, H, dqk, dv), f32), TSpec((B, H, dqk), f32),
                      TSpec((B, H), f32)))


def _slstm_spec(cfg: ArchConfig, B: int) -> Dict:
    H = cfg.n_heads
    t = TSpec((B, H, cfg.d_model // H), torch.float32)
    return dict(h=t, c=t, n=t, m=t)


def _mamba_spec(cfg: ArchConfig, B: int) -> Dict:
    Din = cfg.ssm_expand * cfg.d_model
    return dict(conv=TSpec((B, cfg.conv_kernel - 1, Din), torch.float32),
                h=TSpec((B, Din, cfg.ssm_state), torch.float32))


def block_cache_spec(cfg: ArchConfig, kind: str, B: int, max_len: int,
                     enc_len: int = 0, dtype=torch.bfloat16) -> Dict:
    if kind == "mlstm":
        return _mlstm_spec(cfg, B)
    if kind == "slstm":
        return _slstm_spec(cfg, B)
    window = block_window(cfg, kind)
    smax = min(window, max_len) if window else max_len
    if kind.startswith("mla"):
        return _mla_spec(cfg, B, smax, dtype)
    if kind in HYBRID_KINDS:
        return dict(attn=_attn_spec(cfg, B, smax, dtype),
                    mamba=_mamba_spec(cfg, B))
    if kind == "dec_attn":
        cross = TSpec((B, enc_len, cfg.n_kv_heads, cfg.head_dim), dtype)
        return dict(self=_attn_spec(cfg, B, smax, dtype),
                    cross=dict(k=cross, v=cross))
    if kind in ("attn", "attn_local", "attn_global", "attn_moe"):
        return _attn_spec(cfg, B, smax, dtype)
    raise ValueError(f"no cache spec for kind {kind!r}")


def cache_spec(cfg: ArchConfig, batch_size: int, max_len: int,
               enc_len: int = 0, dtype=torch.bfloat16) -> List:
    """Spec tree for the full decode state, one entry per layer group;
    ``enc_len``: the encoder's length, for an encoder-decoder's cross
    cache."""
    out = []
    for grp in layer_plan(cfg):
        unit = {f"b{j}": block_cache_spec(cfg, kind, batch_size, max_len,
                                          enc_len, dtype)
                for j, kind in enumerate(grp.kinds)}
        out.append(tmap(lambda s: TSpec((grp.repeats,) + s.shape, s.dtype),
                        unit))
    return out


def cache_bytes(spec: List) -> int:
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype)
               .element_size() for s in leaves(spec))
