"""Transformer building blocks of the port, dense-attention subset (the
reference's ``models/layers.py``).

Attention goes through ``attend``: on CUDA tensors every call, prefill and
decode alike, launches the hand-written kernel
(``kernels/flash_attention.py``, ``csrc/flash_attention.cu``); on CPU
tensors it runs the plain versions with the reference's split (direct for
Sq <= 8, chunked online softmax otherwise).  The projections and the MLP
are plain matrix products, as the reference leaves them to XLA.

A block's parameters are read by name (``params["wq"]``), so a dict of
tensors and a ``models.model.ParamBlock`` both serve.  Weights are cast to
the activation dtype at each use, as in the reference; that cast is a no-op
when the model was built or loaded in that dtype.  MLA, MoE and the
custom-VJP backward come with their own slices (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import flash_attention as fa
from ..kernels.flash_attention import (DECODE_DIRECT_MAX_Q, direct_attention,
                                       flash_attention, softcap)
from .config import ArchConfig

__all__ = ["Init", "rms_norm", "rope", "softcap", "flash_attention",
           "direct_attention", "attend", "init_attention", "attention",
           "init_mlp", "mlp", "DECODE_DIRECT_MAX_Q"]

# ---------------------------------------------------------------------------
# init helper
# ---------------------------------------------------------------------------


class Init:
    """Collects named parameter tensors, made from one ``torch.Generator``.

    The reference's scales: normal with 1/sqrt(fan_in) unless given, zeros
    for norms.  Matrices are made in ``dtype`` (drawn in float32, cast
    once); 1-D norm scales stay float32, as the reference reads them in
    ``rms_norm``.  On the ``meta`` device nothing is allocated or drawn.
    """

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device, dtype: torch.dtype):
        self.gen, self.device, self.dtype = generator, device, dtype
        self.params: Dict[str, torch.Tensor] = {}

    def mk(self, name: str, shape, scale: Optional[float] = None,
           mode: str = "normal") -> None:
        dtype = torch.float32 if len(shape) == 1 else self.dtype
        if self.device.type == "meta":
            val = torch.empty(shape, dtype=dtype, device=self.device)
        elif mode == "zeros":
            val = torch.zeros(shape, dtype=dtype, device=self.device)
        else:
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(1, fan_in))
            val = torch.randn(shape, generator=self.gen, device=self.device,
                              dtype=torch.float32).mul_(scale).to(dtype)
        self.params[name] = val


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         rot_dims: Optional[int] = None) -> torch.Tensor:
    """Rotary embedding on the last dim; x [..., S, H, D], positions [S]."""
    d = rot_dims or x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:d]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2, x[..., d:].float()], -1).to(x.dtype)


def attend(q, k, v, *, q_positions, kv_positions, causal=True, window=None,
           logit_cap=None) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Skv, KH, D(v)] -> [B, Sq, H, Dv].  CUDA
    tensors: the flash-attention kernel for every Sq (output in q's dtype).
    CPU tensors: the plain versions, direct for Sq <= 8, chunked otherwise
    (float32 output, as the reference's)."""
    if q.is_cuda:
        return fa.flash_attention_cuda(q, k, v, q_positions, kv_positions,
                                       causal=causal, window=window,
                                       logit_cap=logit_cap)
    return fa.attention_plain(q, k, v, q_positions=q_positions,
                              kv_positions=kv_positions, causal=causal,
                              window=window, logit_cap=logit_cap)


# ---------------------------------------------------------------------------
# attention block (GQA / SWA / softcap / qk-norm) with KV cache
# ---------------------------------------------------------------------------


def init_attention(ini: Init, cfg: ArchConfig, prefix: str = "") -> None:
    D, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ini.mk(prefix + "wq", (D, H * Dh))
    ini.mk(prefix + "wk", (D, KH * Dh))
    ini.mk(prefix + "wv", (D, KH * Dh))
    ini.mk(prefix + "wo", (H * Dh, D),
           scale=1.0 / math.sqrt(H * Dh * 2 * cfg.n_layers))
    if cfg.qk_norm:
        ini.mk(prefix + "q_norm", (Dh,), mode="zeros")
        ini.mk(prefix + "k_norm", (Dh,), mode="zeros")


def attention(params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor, cache: Optional[Dict] = None,
              causal: bool = True, window: Optional[int] = None,
              prefix: str = "") -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B, S, D] -> [B, S, D]; positions [S] int32.  cache: {"k", "v"
    [B, Smax, KH, Dh], "pos_ids" [Smax] int32}, a ring buffer (slot =
    position % Smax) written IN PLACE -- the reference returns new buffers;
    the port updates the cache it is given and returns it, which saves a
    copy of the whole cache per layer and step."""
    B, S, D = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = lambda name: params[prefix + name].to(x.dtype)
    q = (x @ w("wq")).reshape(B, S, H, Dh)
    k = (x @ w("wk")).reshape(B, S, KH, Dh)
    v = (x @ w("wv")).reshape(B, S, KH, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, params[prefix + "q_norm"], cfg.norm_eps)
        k = rms_norm(k, params[prefix + "k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = attend(q, k, v, q_positions=positions, kv_positions=positions,
                     causal=causal, window=window,
                     logit_cap=cfg.attn_logit_softcap)
    else:
        if cache["k"].dtype != k.dtype:
            raise ValueError(f"cache dtype {cache['k'].dtype} differs from "
                             f"the activations' {k.dtype}")
        Smax = cache["k"].shape[1]
        slots = (positions % Smax).long()
        cache["k"][:, slots] = k
        cache["v"][:, slots] = v
        cache["pos_ids"][slots] = positions.to(cache["pos_ids"].dtype)
        out = attend(q, cache["k"], cache["v"], q_positions=positions,
                     kv_positions=cache["pos_ids"], causal=causal,
                     window=window, logit_cap=cfg.attn_logit_softcap)
    out = out.to(x.dtype).reshape(B, S, H * Dh)
    return out @ w("wo"), cache


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------


def init_mlp(ini: Init, d_model: int, d_ff: int, n_layers: int,
             prefix: str = "") -> None:
    ini.mk(prefix + "w_gate", (d_model, d_ff))
    ini.mk(prefix + "w_up", (d_model, d_ff))
    ini.mk(prefix + "w_down", (d_ff, d_model),
           scale=1.0 / math.sqrt(d_ff * 2 * n_layers))


def mlp(params, x: torch.Tensor, prefix: str = "") -> torch.Tensor:
    g = x @ params[prefix + "w_gate"].to(x.dtype)
    u = x @ params[prefix + "w_up"].to(x.dtype)
    return (F.silu(g) * u) @ params[prefix + "w_down"].to(x.dtype)
