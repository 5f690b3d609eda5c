"""Transformer building blocks of the port (the reference's
``models/layers.py``): attention, MLA, the MLP and top-k MoE.

Attention goes through ``attend``: on CUDA tensors every call, prefill and
decode alike, launches the hand-written kernel
(``kernels/flash_attention.py``, ``csrc/flash_attention.cu``); on CPU
tensors it runs the plain versions with the reference's split (direct for
Sq <= 8, chunked online softmax otherwise).  The projections and the MLP
are plain matrix products, as the reference leaves them to XLA; so are
MLA's absorbed decode and the MoE dispatch, which the reference computes
in plain JAX outside any kernel.

A block's parameters are read by name (``params["wq"]``), so a dict of
tensors and a ``models.model.ParamBlock`` both serve.  Weights are cast to
the activation dtype at each use, as in the reference; that cast is a no-op
when the model was built or loaded in that dtype.  Every operation is
differentiable: ``attend``'s backward is the reference's chunked flash
backward, the rest is autograd's.
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

__all__ = ["Init", "FLOAT32_LEAVES", "leaf_dtype", "rms_norm", "rope",
           "softcap", "flash_attention", "direct_attention", "attend", "init_attention", "attention",
           "init_mla", "mla_attention", "init_mlp", "mlp", "init_moe",
           "moe", "moe_plan", "route", "queue_ranks", "moe_dropped",
           "DECODE_DIRECT_MAX_Q"]

# ---------------------------------------------------------------------------
# init helper
# ---------------------------------------------------------------------------


# leaves the reference reads in float32 whatever the activation dtype:
# mamba's A_log (src/repro/models/ssm.py:318) and sLSTM's recurrent
# matrices (ssm.py:243); rounding them would change every recurrence step
FLOAT32_LEAVES = ("A_log", "rz", "ri", "rf", "ro")


def leaf_dtype(name: str, ndim: int, dtype: torch.dtype) -> torch.dtype:
    """The dtype a parameter leaf is kept in: float32 for 1-D leaves (norm
    scales, biases: the reference reads them in float32 or casts them at
    use) and for ``FLOAT32_LEAVES`` under any prefix, ``dtype`` for the
    other matrices."""
    if ndim == 1 or any(name == leaf or name.endswith("_" + leaf)
                        for leaf in FLOAT32_LEAVES):
        return torch.float32
    return dtype


class Init:
    """Collects named parameter tensors, made from one ``torch.Generator``.

    The reference's scales: normal with 1/sqrt(fan_in) unless given, zeros
    for norms, ones where asked (mamba's ``A_log`` and ``D_skip``).
    Leaves take ``leaf_dtype``: matrices are made in ``dtype`` (drawn in
    float32, cast once); 1-D leaves and ``FLOAT32_LEAVES`` stay float32.
    On the ``meta`` device nothing is allocated or drawn.  ``axes`` keeps
    each leaf's logical axes (one name or None a dimension, the
    reference's: ``parallel.sharding`` resolves them on a mesh).
    """

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device, dtype: torch.dtype):
        self.gen, self.device, self.dtype = generator, device, dtype
        self.params: Dict[str, torch.Tensor] = {}
        self.axes: Dict[str, Tuple[Optional[str], ...]] = {}

    def mk(self, name: str, shape, axes, scale: Optional[float] = None,
           mode: str = "normal") -> None:
        if len(axes) != len(shape):
            raise ValueError(f"{name}: axes {axes} for shape {shape}")
        self.axes[name] = tuple(axes)
        dtype = leaf_dtype(name, len(shape), self.dtype)
        if self.device.type == "meta":
            val = torch.empty(shape, dtype=dtype, device=self.device)
        elif mode == "zeros":
            val = torch.zeros(shape, dtype=dtype, device=self.device)
        elif mode == "ones":
            val = torch.ones(shape, dtype=dtype, device=self.device)
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
    (float32 output, as the reference's).  Differentiable on both devices
    (``kernels.flash_attention.attend``: the reference's flash backward)."""
    return fa.attend(q, k, v, q_positions, kv_positions, causal=causal,
                     window=window, logit_cap=logit_cap)


# ---------------------------------------------------------------------------
# attention block (GQA / SWA / softcap / qk-norm) with KV cache
# ---------------------------------------------------------------------------


def init_attention(ini: Init, cfg: ArchConfig, prefix: str = "") -> None:
    D, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ini.mk(prefix + "wq", (D, H * Dh), ("fsdp", "tp"))
    ini.mk(prefix + "wk", (D, KH * Dh), ("fsdp", "tp"))
    ini.mk(prefix + "wv", (D, KH * Dh), ("fsdp", "tp"))
    ini.mk(prefix + "wo", (H * Dh, D), ("tp", "fsdp"),
           scale=1.0 / math.sqrt(H * Dh * 2 * cfg.n_layers))
    if cfg.qk_norm:
        ini.mk(prefix + "q_norm", (Dh,), (None,), mode="zeros")
        ini.mk(prefix + "k_norm", (Dh,), (None,), mode="zeros")


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
        _write_cache(cache, positions, k.dtype, k=k, v=v)
        out = attend(q, cache["k"], cache["v"], q_positions=positions,
                     kv_positions=cache["pos_ids"], causal=causal,
                     window=window, logit_cap=cfg.attn_logit_softcap)
    out = out.to(x.dtype).reshape(B, S, H * Dh)
    return out @ w("wo"), cache


def _write_cache(cache: Dict, positions: torch.Tensor, dtype,
                 **new: torch.Tensor) -> None:
    """Write ``new`` leaves [B, S, ...] at the ring-buffer slots of
    ``positions`` and record the positions, in place."""
    for name in new:
        if cache[name].dtype != dtype:
            raise ValueError(f"cache dtype {cache[name].dtype} differs from "
                             f"the activations' {dtype}")
    Smax = cache["pos_ids"].shape[0]
    slots = (positions % Smax).long()
    for name, t in new.items():
        cache[name][:, slots] = t
    cache["pos_ids"][slots] = positions.to(cache["pos_ids"].dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV with decoupled RoPE
# ---------------------------------------------------------------------------


def init_mla(ini: Init, cfg: ArchConfig) -> None:
    D, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_dim
    ini.mk("wq_a", (D, cfg.q_lora_rank), ("fsdp", None))
    ini.mk("q_a_norm", (cfg.q_lora_rank,), (None,), mode="zeros")
    ini.mk("wq_b", (cfg.q_lora_rank, H * (dn + dr)), (None, "tp"))
    ini.mk("wkv_a", (D, cfg.kv_lora_rank + dr), ("fsdp", None))
    ini.mk("kv_a_norm", (cfg.kv_lora_rank,), (None,), mode="zeros")
    ini.mk("wk_b", (cfg.kv_lora_rank, H * dn), (None, "tp"))
    ini.mk("wv_b", (cfg.kv_lora_rank, H * dv), (None, "tp"))
    ini.mk("wo", (H * dv, D), ("tp", "fsdp"),
           scale=1.0 / math.sqrt(H * dv * 2 * cfg.n_layers))


def mla_attention(params, x: torch.Tensor, cfg: ArchConfig, *,
                  positions: torch.Tensor, cache: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B, S, D] -> [B, S, D].  cache: {"c_kv" [B, Smax, kv_lora],
    "k_rope" [B, Smax, dr], "pos_ids" [Smax] int32}, the compressed KV,
    written in place as ``attention`` writes its cache.

    With a cache and S <= ``DECODE_DIRECT_MAX_Q`` the absorbed path runs in
    the compressed space, in float32 (W^UK folded into q, W^UV applied
    after the softmax), never expanding the cache; every other call expands
    it to per-head K [.., dn + dr] and V [.., dv] and goes through
    ``attend`` (the flash kernel on the card)."""
    B, S, D = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_dim
    rank = cfg.kv_lora_rank
    w = lambda name: params[name].to(x.dtype)

    qa = rms_norm(x @ w("wq_a"), params["q_a_norm"], cfg.norm_eps)
    q = (qa @ w("wq_b")).reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = rope(q[..., dn:], positions, cfg.rope_theta)

    kv_a = x @ w("wkv_a")                                  # [B, S, rank+dr]
    c_kv = rms_norm(kv_a[..., :rank], params["kv_a_norm"], cfg.norm_eps)
    k_rope = rope(kv_a[..., None, rank:], positions, cfg.rope_theta)[:, :, 0]
    pos_ids = positions
    if cache is not None:
        _write_cache(cache, positions, x.dtype, c_kv=c_kv, k_rope=k_rope)
        c_kv, k_rope, pos_ids = cache["c_kv"], cache["k_rope"], \
            cache["pos_ids"]

    if S <= DECODE_DIRECT_MAX_Q and cache is not None:
        # absorbed decode: q_c = q_nope . W^UK (per head), scores against
        # c_kv and k_rope, softmax, then (p . c_kv) . W^UV
        wk_b = w("wk_b").reshape(rank, H, dn)
        wv_b = w("wv_b").reshape(rank, H, dv)
        q_c = torch.einsum("bshd,rhd->bshr", q_nope, wk_b).float()
        scale = 1.0 / math.sqrt(dn + dr)
        s = (torch.einsum("bshr,bkr->bshk", q_c, c_kv.float()) * scale
             + torch.einsum("bshd,bkd->bshk", q_rope.float(),
                            k_rope.float()) * scale)
        rel = positions[None, :, None, None] - pos_ids[None, None, None, :]
        mask = (pos_ids >= 0)[None, None, None, :] & (rel >= 0)
        s = torch.where(mask, s, torch.tensor(-math.inf, device=x.device))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isneginf(m), 0.0, m))
        p = torch.where(mask, p, 0.0)
        p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-20)
        out_c = torch.einsum("bshk,bkr->bshr", p, c_kv.float())
        out = torch.einsum("bshr,rhv->bshv", out_c.to(x.dtype), wv_b)
    else:
        # expand the compressed KV to per-head keys and values; K is made
        # contiguous (the rope part broadcast to every head) for the kernel
        Skv = c_kv.shape[1]
        k_nope = (c_kv @ w("wk_b")).reshape(B, Skv, H, dn)
        val = (c_kv @ w("wv_b")).reshape(B, Skv, H, dv)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, Skv, H, dr)], -1)
        q_full = torch.cat([q_nope, q_rope], -1)
        out = attend(q_full, k_full, val, q_positions=positions,
                     kv_positions=pos_ids, causal=True)
    out = out.to(x.dtype).reshape(B, S, H * dv)
    return out @ w("wo"), cache


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------


def init_mlp(ini: Init, d_model: int, d_ff: int, n_layers: int,
             prefix: str = "") -> None:
    ini.mk(prefix + "w_gate", (d_model, d_ff), ("fsdp", "tp"))
    ini.mk(prefix + "w_up", (d_model, d_ff), ("fsdp", "tp"))
    ini.mk(prefix + "w_down", (d_ff, d_model), ("tp", "fsdp"),
           scale=1.0 / math.sqrt(d_ff * 2 * n_layers))


def mlp(params, x: torch.Tensor, prefix: str = "") -> torch.Tensor:
    g = x @ params[prefix + "w_gate"].to(x.dtype)
    u = x @ params[prefix + "w_up"].to(x.dtype)
    return (F.silu(g) * u) @ params[prefix + "w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# top-k MoE with capacity-based dispatch
# ---------------------------------------------------------------------------

MOE_IMPLS = ("ep_sort", "sort", "onehot")
# tokens from which the default ``ep_sort`` takes the expert-parallel path
# (the reference's threshold; below it, ``sort``)
MOE_EP_MIN_TOKENS = 4096


def init_moe(ini: Init, cfg: ArchConfig) -> None:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    ini.mk("router", (D, E), ("fsdp", None), scale=0.02)
    ini.mk("we_gate", (E, D, Fe), ("expert", "fsdp", None))
    ini.mk("we_up", (E, D, Fe), ("expert", "fsdp", None))
    ini.mk("we_down", (E, Fe, D), ("expert", None, "fsdp"),
           scale=1.0 / math.sqrt(Fe * 2 * cfg.n_layers))
    if cfg.n_shared_experts:
        init_mlp(ini, D, Fe * cfg.n_shared_experts, cfg.n_layers,
                 prefix="shared_")


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: capacity_factor x tokens x
    top_k / n_experts truncated by ``int``, rounded up to a multiple of 16,
    at least 16 (the reference's formula on each path)."""
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(16, -(-c // 16) * 16)


def moe_plan(cfg: ArchConfig, B: int, S: int, impl: str = "ep_sort"
             ) -> Tuple[str, int, int]:
    """(path, capacity, chunk) of ``moe`` on a [B, S] batch.  ``ep_sort``
    takes "ep" from ``MOE_EP_MIN_TOKENS`` tokens, "sort" below; "ep" and
    "sort" dispatch all B * S tokens at once (chunk = S; one device, so
    the expert-parallel path's local tokens are all of them), "onehot" in
    groups of B * chunk tokens cut along the sequence, chunk the largest
    divisor of S up to ``moe_group_tokens // B``."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}; one of {MOE_IMPLS}")
    if impl == "ep_sort":
        impl = "ep" if B * S >= MOE_EP_MIN_TOKENS else "sort"
    if impl != "onehot":
        return impl, _capacity(cfg, B * S), S
    chunk = max(1, min(S, cfg.moe_group_tokens // B))
    while S % chunk:
        chunk -= 1
    return impl, _capacity(cfg, B * chunk), chunk


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xg [T, D] -> (gates [T, K] float32, summing to 1 over k; experts
    [T, K] int64).  The top k come from a stable descending sort, so equal
    probabilities keep expert order, as ``lax.top_k``'s do (``torch.topk``
    breaks such ties otherwise; bf16 router logits tie often)."""
    logits = (xg @ router.to(xg.dtype)).float()
    probs = torch.softmax(logits, -1)
    vals, idx = torch.sort(probs, stable=True, dim=-1, descending=True)
    gates, idx = vals[:, :top_k], idx[:, :top_k]
    return gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9), idx


def queue_ranks(experts: torch.Tensor) -> torch.Tensor:
    """experts [T, K] -> each (token, k)'s place [T, K] in its expert's
    queue, the queue in (token, k) order: a stable sort by expert, minus
    the start of the expert's run."""
    flat = experts.reshape(-1)
    perm = torch.argsort(flat, stable=True)
    srt = flat[perm]
    ranks_sorted = (torch.arange(flat.numel(), device=flat.device)
                    - torch.searchsorted(srt, srt))
    ranks = torch.empty_like(ranks_sorted)
    ranks[perm] = ranks_sorted
    return ranks.reshape(experts.shape)


def _expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """xe [E, C, D] -> [E, C, D] through each expert's gated MLP (the
    reference's ``_expert_ffn``, and ``_expert_ffn_dsharded`` on one
    device)."""
    dt = xe.dtype
    g = torch.bmm(xe, params["we_gate"].to(dt))
    u = torch.bmm(xe, params["we_up"].to(dt))
    return torch.bmm(F.silu(g) * u, params["we_down"].to(dt))


def moe_sort_group(params, xg: torch.Tensor, cfg: ArchConfig,
                   cap: int) -> torch.Tensor:
    """Sort-based dispatch of xg [T, D] into an [E, cap, D] buffer, the
    experts, then the gate-weighted combine -> [T, D].

    A (token, k) past its expert's capacity goes to one spare row behind
    the buffer, which the experts never see (the reference's
    ``mode="drop"``): no out-of-range index, no host sync.  In-capacity
    slots are unique, so the scatter is deterministic.  The combine is a
    gather of [T, K, D] and a float32 sum over k, no scatter-add."""
    T, D = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    gates, experts = route(params["router"], xg, K)
    ranks = queue_ranks(experts)
    in_cap = ranks < cap
    slot = torch.where(in_cap, experts * cap + ranks, E * cap)
    xe = xg.new_zeros((E * cap + 1, D))
    xe[slot.reshape(-1)] = xg.repeat_interleave(K, 0)
    ye = _expert_ffn(params, xe[:-1].view(E, cap, D)).reshape(E * cap, D)
    ytk = ye[(experts * cap + ranks.clamp_max(cap - 1)).reshape(-1)]
    w = (gates * in_cap).to(ytk.dtype)
    y = torch.einsum("tkd,tk->td", ytk.reshape(T, K, D).float(), w.float())
    return y.to(xg.dtype)


def moe_ep(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The reference's expert-parallel MoE with no mesh (one device): one
    shard's body over all t_local = B * S tokens -- the sort dispatch with
    the capacity of t_local, then the shared experts."""
    B, S, D = x.shape
    xg = x.reshape(B * S, D)
    y = moe_sort_group(params, xg, cfg, _capacity(cfg, B * S))
    if cfg.n_shared_experts:
        y = y + mlp(params, xg, prefix="shared_")
    return y.reshape(B, S, D)


def moe_onehot_group(params, xg: torch.Tensor, cfg: ArchConfig,
                     cap: int) -> torch.Tensor:
    """GShard-style matmul dispatch for one token group xg [Tg, D]: queue
    positions by a cumulative sum of the expert one-hots, dispatch and
    combine as [Tg, E, cap] products."""
    Tg, D = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    gates, experts = route(params["router"], xg, K)
    onehot = F.one_hot(experts, E).float()                    # [Tg, K, E]
    pos = (torch.cumsum(onehot.reshape(Tg * K, E), 0) - 1.0).reshape(
        Tg, K, E)
    pos_sel = torch.gather(pos, -1, experts[..., None])[..., 0]  # [Tg, K]
    in_cap = (pos_sel < cap).float()
    poh = F.one_hot(pos_sel.clamp(0, cap - 1).long(), cap).float()
    disp = torch.einsum("tke,tkc,tk->tec", onehot, poh, in_cap)
    comb = torch.einsum("tec,tke,tk->tec", disp, onehot, gates)
    xe = torch.einsum("tec,td->ecd", disp.to(xg.dtype), xg)
    ye = _expert_ffn(params, xe)
    y = torch.einsum("tec,ecd->td", comb.to(xg.dtype).float(), ye.float())
    return y.to(xg.dtype)


def _groups(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """[B, S, ...] -> [S // chunk, B * chunk, ...]: groups cut along the
    sequence."""
    B, S = x.shape[:2]
    n = S // chunk
    return x.reshape(B, n, chunk, *x.shape[2:]).transpose(0, 1).reshape(
        n, B * chunk, *x.shape[2:])


def _ungroup(y: torch.Tensor, B: int) -> torch.Tensor:
    n, Tg = y.shape[:2]
    return y.reshape(n, B, Tg // B, *y.shape[2:]).transpose(0, 1).reshape(
        B, n * (Tg // B), *y.shape[2:])


def moe(params, x: torch.Tensor, cfg: ArchConfig,
        impl: str = "ep_sort") -> torch.Tensor:
    """Top-k MoE with capacity-based dispatch, x [B, S, D] -> [B, S, D];
    ``moe_plan`` says which path and capacity.  The shared experts are
    added after the sort and onehot paths (inside the expert-parallel
    one)."""
    B, S, D = x.shape
    path, cap, chunk = moe_plan(cfg, B, S, impl)
    if path == "ep":
        return moe_ep(params, x, cfg)
    if path == "sort":
        y = moe_sort_group(params, x.reshape(B * S, D), cfg,
                           cap).reshape(B, S, D)
    else:
        y = _ungroup(torch.stack([moe_onehot_group(params, xg, cfg, cap)
                                  for xg in _groups(x, chunk)]), B)
    if cfg.n_shared_experts:
        y = y + mlp(params, x, prefix="shared_")
    return y


def moe_dropped(params, x: torch.Tensor, cfg: ArchConfig,
                impl: str = "ep_sort") -> torch.Tensor:
    """[B, S, K] bool: the (token, k) pairs ``moe`` drops, past their
    expert's capacity in their group."""
    path, cap, chunk = moe_plan(cfg, x.shape[0], x.shape[1], impl)
    drops = [queue_ranks(route(params["router"], xg, cfg.top_k)[1]) >= cap
             for xg in _groups(x, chunk)]
    return _ungroup(torch.stack(drops), x.shape[0])
