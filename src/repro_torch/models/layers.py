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

**Sharded serving.**  Under ``parallel.sharding.mesh_context(mesh)`` a
cache leaf laid out along ``("batch", "kv_seq", ...)`` may be this rank's
block (``serve.cache.zeros(..., mesh=mesh)``): where the ``kv_seq`` rule
splits the cache's Smax slots over the mesh axes it names ("model"), the
rank at model coordinate r holds slots [r Smax/m, (r+1) Smax/m), and
``pos_ids`` stays whole on every rank (every rank writes it, and reads its
block's slice).  Then
  * a prefill (S > 1; it must start at position 0, as the engine's do)
    attends the call's last min(S, Smax) fresh K/V at their positions --
    equal to attending the cache after the write, since every stale slot
    that survives the write holds a position >= S, which the causal mask
    drops -- with no collective, and keeps its block of the write;
  * a decode step (S == 1) writes the new K/V on the owner of its slot
    only (found on the host from the position the engine records),
    attends its block (``kernels.flash_attention.attend_lse``: the
    split-KV kernel with its log-sum-exp output on the card), all-gathers
    (out, lse) over the mesh axes that split the cache (one buffer a
    layer: B x H x Dv values and B x H float32 a rank) and combines by
    log-sum-exp; a rank whose block is fully masked has lse = -inf and
    weight 0.
The combine runs even when those axes hold one rank, so a (1, 1) mesh on
one card drives it.  Where the rule drops ``kv_seq`` (the model axis does
not divide Smax) the leaf is whole on every rank and the single-device
path runs on the rank's batch block.  An MoE layer on a batch split over
the mesh keeps the reference's capacity semantics (``moe``): from the
sizes the engine records (``parallel.sharding.step_fact``), it counts the
whole batch's tokens and queues them across the ranks below the
expert-parallel threshold.

**Tensor-parallel serving.**  Under the serving step's model group
(``parallel.sharding.tensor_parallel``: the "model" axis of more than one
rank) the served view hands a layer the rank's blocks of the leaves
``models.model.tp_leaves`` names, and each of the reference's activation
constraints becomes the layout the activation has on the rank, with one
named collective where two consecutive constraints disagree:
  * ``attention``: q for the rank's H / n heads (``head_share``; the
    reference's ``shard(q, ..., "heads", ...)``), k and v for its KH / n
    kv heads where n divides them, else whole, the rank's query heads
    reading their groups' kv heads (``kv_for_heads``).  Where n does not
    divide the heads and S > ``DECODE_DIRECT_MAX_Q`` the rank takes S / n
    query rows instead (the reference's ``q_seq`` fallback, hymba's 25
    heads), attends them against the whole K/V and the rows are
    all-gathered after ``wo`` (``tp_output``).  Without a cache the rank
    attends with no collective.  A cache takes every kv head: the fresh
    K/V split by heads are all-gathered along the heads (``gather_heads``;
    the reshard between ``shard(k, ..., "heads", ...)`` and ``shard(ck,
    "batch", "kv_seq", ...)`` as an all-gather and the owner's slice of
    the slots), the rank then attending its heads' kv heads of the cache
    (whole) or of the fresh K/V (a prefill into a ``kv_seq`` block).  A
    decode step over a ``kv_seq`` block gathers the one-token q of every
    head in the same all-gather, attends every head on its block, combines
    the ranks' (out, lse) (``combine_ranks``) and keeps its heads.  ``out
    @ wo`` is then a partial sum over the heads, all-reduced over the
    group (the reference's ``shard(y, "batch", None, None)``);
  * ``mlp``: the rank's d_ff / n columns of w_gate / w_up, its rows of
    w_down, the products all-reduced (the reference's ``shard(h, ...,
    "tp")`` then ``shard(y, ...)``);
  * MLA, the MoE (its experts and shared expert) and the recurrent blocks
    compute whole on every rank, from leaves gathered whole.

A block's parameters are read by name (``params["wq"]``), so a dict of
tensors and a ``models.model.ParamBlock`` both serve.  Weights are cast to
the activation dtype at each use, as in the reference; that cast is a no-op
when the model was built or loaded in that dtype.  Every operation is
differentiable: ``attend``'s backward is the reference's chunked flash
backward, the rest is autograd's.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import flash_attention as fa
from ..kernels.flash_attention import (DECODE_DIRECT_MAX_Q, direct_attention,
                                       flash_attention, softcap)
from ..parallel import sharding as sh
from .config import ArchConfig

__all__ = ["Init", "FLOAT32_LEAVES", "leaf_dtype", "rms_norm", "rope",
           "softcap", "flash_attention", "direct_attention", "attend", "init_attention", "attention",
           "init_mla", "mla_attention", "init_mlp", "mlp", "init_moe",
           "moe", "moe_plan", "route", "queue_ranks", "moe_dropped",
           "combine_ranks", "head_share", "kv_for_heads", "gather_heads",
           "tp_output", "DECODE_DIRECT_MAX_Q"]

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
    copy of the whole cache per layer and step.  Under a model group
    (``parallel.sharding.tensor_parallel``) the rank computes its share
    (module docstring, tensor-parallel serving)."""
    B, S, D = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = lambda name: params[prefix + name].to(x.dtype)
    g, h0, Hq = head_share(H)
    rows = _q_rows(H, S)
    xq, q_pos = x, positions
    if rows is not None:
        xq, q_pos = x[:, rows[0]:rows[0] + rows[1]], \
            positions[rows[0]:rows[0] + rows[1]]
    KHl = KH // g.size if g is not None and KH % g.size == 0 else KH
    q = (xq @ w("wq")).reshape(B, -1, Hq, Dh)
    k = (x @ w("wk")).reshape(B, S, KHl, Dh)
    v = (x @ w("wv")).reshape(B, S, KHl, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, params[prefix + "q_norm"], cfg.norm_eps)
        k = rms_norm(k, params[prefix + "k_norm"], cfg.norm_eps)
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kw = dict(causal=causal, window=window, logit_cap=cfg.attn_logit_softcap)
    # the kv heads the rank's query heads read, of a tensor of all KH
    sel = (lambda t: t) if g is None else \
        (lambda t: kv_for_heads(t, h0, Hq, H // KH))
    if cache is None:
        out = attend(q, k if KHl < KH else sel(k), v if KHl < KH else sel(v),
                     q_positions=q_pos, kv_positions=positions, **kw)
    else:
        blk = _kv_block(cache, "k")
        decode_split = blk is not None and S == 1
        q_all = q
        if g is not None and (KHl < KH or decode_split):
            # the cache takes every kv head, and a decode step over a
            # split cache attends every query head on the rank's slots
            parts = gather_heads(g, *([q] if decode_split else []),
                                 *([k, v] if KHl < KH else []))
            if decode_split:
                q_all = parts.pop(0)
            if KHl < KH:
                k, v = parts
        if blk is None:
            _write_cache(cache, positions, k.dtype, k=k, v=v)
            out = attend(q, sel(cache["k"]), sel(cache["v"]),
                         q_positions=q_pos, kv_positions=cache["pos_ids"],
                         **kw)
        elif S > 1:
            k, v, kv_pos = _write_block(cache, positions, blk, k.dtype,
                                        k=k, v=v)
            out = attend(q, sel(k), sel(v), q_positions=q_pos,
                         kv_positions=kv_pos, **kw)
        else:
            _, _, kv_pos = _write_block(cache, positions, blk, k.dtype,
                                        k=k, v=v)
            out = combine_ranks(*fa.attend_lse(
                q_all, cache["k"], cache["v"], positions, kv_pos, **kw),
                blk[2])[:, :, h0:h0 + Hq]
    out = out.to(x.dtype).reshape(B, -1, Hq * Dh)
    return tp_output(out @ w("wo"), g, rows), cache


def head_share(H: int) -> Tuple[Optional[sh.TensorParallel], int, int]:
    """(group, first head, heads) of the query heads this rank computes:
    its block of the H heads where the model group splits them
    (``parallel.sharding.tp_of``), else (None, 0, H)."""
    g = sh.tp_of(H)
    if g is None:
        return None, 0, H
    h0, hl = g.block(H)
    return g, h0, hl


def _q_rows(H: int, S: int) -> Optional[Tuple[int, int]]:
    """The reference's fallback to sequence parallelism
    (``src/repro/models/layers.py:369-375``): where the model group does
    not split the H heads and S > ``DECODE_DIRECT_MAX_Q``, the (start,
    width) of the query rows this rank computes (the ``q_seq`` rule: None
    where the group does not divide S either, and the layer runs whole)."""
    g = sh.tp()
    if (g is None or H % g.size == 0 or S <= DECODE_DIRECT_MAX_Q
            or S % g.size):
        return None
    return g.block(S)


def kv_for_heads(t: torch.Tensor, h0: int, hl: int, G: int) -> torch.Tensor:
    """The kv heads of ``t`` [B, S, KH, D] that query heads [h0, h0 + hl)
    read (GQA groups of G query heads a kv head), contiguous: a slice
    where the rank's heads cover whole groups or share one group, else
    one kv head a query head."""
    if hl % G == 0:
        t = t[:, :, h0 // G:(h0 + hl) // G]
    elif G % hl == 0:
        t = t[:, :, h0 // G:h0 // G + 1]
    else:
        t = t.index_select(2, torch.arange(h0, h0 + hl, device=t.device)
                           // G)
    return t.contiguous()


def gather_heads(g: sh.TensorParallel, *xs: torch.Tensor) -> list:
    """Each of ``xs`` [B, S, h_i, D] (one B, S, D) with every rank's heads,
    concatenated along the heads in rank order: one all-gather over the
    model group of the pieces packed along the heads."""
    got = sh.gather_ranks(torch.cat(xs, 2), g.axes)      # [n, B, S, sum, D]
    out = []
    for piece in got.split([t.shape[2] for t in xs], 3):
        n, B, S, h, D = piece.shape
        out.append(piece.permute(1, 2, 0, 3, 4).reshape(B, S, n * h, D))
    return out


def tp_output(y: torch.Tensor, g: Optional[sh.TensorParallel],
              rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """A block's output projection y [B, S', D] made whole on the model
    group: the sum of the ranks' partial products where ``g`` split the
    contraction (all-reduce: the reference's ``shard(y, "batch", None,
    None)``), the ranks' query rows concatenated where the fallback split
    them (all-gather), else ``y``."""
    if g is not None:
        return sh.all_reduce(y, g.axes)
    if rows is not None:
        return sh.all_gather(y, 1, sh.tp().axes)
    return y


def _check_dtypes(cache: Dict, dtype, names) -> None:
    for name in names:
        if cache[name].dtype != dtype:
            raise ValueError(f"cache dtype {cache[name].dtype} differs from "
                             f"the activations' {dtype}")


def _last_ring(positions: torch.Tensor, Smax: int, new: Mapping
               ) -> Tuple[torch.Tensor, Dict]:
    """The call's last ``Smax`` positions and their leaves [B, S, ...]:
    what a ring of ``Smax`` slots keeps of a longer write (each slot the
    last of its positions, as the reference's last-wins scatter leaves
    it).  The positions are consecutive, as the engine makes them."""
    S = positions.shape[0]
    if S <= Smax:
        return positions, dict(new)
    return positions[S - Smax:], {name: t[:, S - Smax:]
                                  for name, t in new.items()}


def _write_cache(cache: Dict, positions: torch.Tensor, dtype,
                 **new: torch.Tensor) -> None:
    """Write ``new`` leaves [B, S, ...] at the ring-buffer slots of
    ``positions`` and record the positions, in place.  A call longer than
    the ring writes only its last Smax positions (``_last_ring``), so no
    slot is written twice in one indexed write, whose order neither the
    CPU's thread pool nor CUDA fixes."""
    _check_dtypes(cache, dtype, new)
    Smax = cache["pos_ids"].shape[0]
    for name in new:
        if cache[name].shape[1] != Smax:
            raise ValueError(
                f"cache {name} holds {cache[name].shape[1]} of {Smax} slots: "
                "a rank's block serves only under its mesh_context")
    positions, new = _last_ring(positions, Smax, new)
    slots = (positions % Smax).long()
    for name, t in new.items():
        cache[name][:, slots] = t
    cache["pos_ids"][slots] = positions.to(cache["pos_ids"].dtype)


def _kv_block(cache: Dict, name: str
              ) -> Optional[Tuple[int, int, Tuple[str, ...]]]:
    """(start, width, axes) of the slots this rank holds of ``cache[name]``
    under the active mesh (module docstring), or None when no mesh axis
    splits its ``kv_seq`` (no mesh, or the rule drops it: the leaf is
    whole)."""
    Smax = cache["pos_ids"].shape[0]
    start, width, axes = sh.dim_block("kv_seq", Smax)
    if not axes:
        return None
    if cache[name].shape[1] != width:
        raise ValueError(f"cache {name} holds {cache[name].shape[1]} slots; "
                         f"its block of {Smax} under the mesh is {width}")
    return start, width, axes


def _host_first(positions: torch.Tensor) -> int:
    """The first position's value: the one the step recorded
    (``parallel.sharding.step_fact("position")``: the engine's), else on
    meta from the dry run's tracer, else read from the device."""
    first = sh.step_fact("position")
    if first is not None:
        return first
    if positions.is_meta:
        if fa.META_TRACE is None:
            raise RuntimeError("attention on the meta device runs only under "
                               "launch.roofline.analyze_step")
        return int(fa.META_TRACE.positions(positions)[0])
    return int(positions[0])


def _write_block(cache: Dict, positions: torch.Tensor,
                 blk: Tuple[int, int, Tuple[str, ...]], dtype,
                 **new: torch.Tensor):
    """The sharded write (module docstring): ``pos_ids`` whole on every
    rank, each leaf's slots in this rank's block ``blk`` only.  A decode
    step (S == 1) writes its slot on the rank that owns it, found from the
    position the step recorded (``_host_first``: no device read).  A
    prefill (S > 1, from position 0, checked) copies the block's slots of
    the call's last min(S, Smax) positions by index (host-computed, each
    slot once).  Returns what the call attends: for a prefill those fresh
    leaves and positions, for a decode step the block's leaves and
    positions."""
    _check_dtypes(cache, dtype, new)
    Smax = cache["pos_ids"].shape[0]
    start, width, _ = blk
    S = positions.shape[0]
    first = _host_first(positions)
    if S == 1:
        local = first % Smax - start
        if 0 <= local < width:
            for name, t in new.items():
                cache[name][:, local] = t[:, 0]
        cache["pos_ids"][first % Smax] = first
        return (None,) * len(new) + (cache["pos_ids"][start:start + width],)
    if first != 0:
        raise ValueError("a sharded prefill starts at position 0 (the "
                         "engine's); decode steps one token at a time")
    n = min(S, Smax)
    q = np.arange(S - n, S)
    g = q % Smax
    sel = (g >= start) & (g < start + width)
    dev = positions.device
    src = torch.as_tensor(q[sel], device=dev)
    dst = torch.as_tensor(g[sel] - start, device=dev)
    for name, t in new.items():
        cache[name].index_copy_(1, dst, t.index_select(1, src))
    last, fresh = _last_ring(positions, Smax, new)
    cache["pos_ids"][(last % Smax).long()] = last.to(cache["pos_ids"].dtype)
    return tuple(t.contiguous() for t in fresh.values()) + (last,)


def _ranks(axes: Tuple[str, ...]) -> int:
    """The number of ranks along ``axes`` of the active mesh."""
    sizes = sh.mesh_shape(sh.current_mesh())
    return math.prod(sizes[a] for a in axes)


def combine_ranks(out: torch.Tensor, lse: torch.Tensor,
                  axes: Tuple[str, ...]) -> torch.Tensor:
    """Attention over every rank's block of the kv slots from each rank's
    ``out`` [B, Sq, H, Dv] over its own block and its ``lse`` [B, H, Sq]
    (float32, -inf where the block has no unmasked slot): one all-gather
    of both over ``axes`` (packed into one buffer in out's dtype), then
    sum_r e^(lse_r - L) out_r with L = log sum_r e^(lse_r), in float32; 0
    for a row no rank has a slot for.  -> out's dtype.  One rank: nothing
    is gathered or packed, and the sum is out itself (its weight e^0 =
    1): at one rank the combine shows the path runs, not that its
    arithmetic is right (the multi-rank CPU tests show that)."""
    B, Sq, H, Dv = out.shape
    dt = out.dtype
    if _ranks(axes) == 1:
        outs, lses = out[None].float(), lse.transpose(1, 2)[None]
    else:
        lse_t = lse.transpose(1, 2).contiguous()              # [B, Sq, H]
        packed = torch.cat([out.reshape(B, Sq, H * Dv),
                            lse_t.view(dt) if dt != torch.float32
                            else lse_t], -1)
        got = sh.gather_ranks(packed, axes)
        n = got.shape[0]
        outs = got[..., :H * Dv].reshape(n, B, Sq, H, Dv).float()
        lses = got[..., H * Dv:].contiguous().view(torch.float32)
    # the weights e^(lse_r - L); a row with every lse -inf gives NaN, then 0
    wts = torch.softmax(lses, 0).nan_to_num_(0.0)            # [n, B, Sq, H]
    return (wts[..., None] * outs).sum(0).to(dt)


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
    ``attend`` (the flash kernel on the card).  A cache split along
    ``kv_seq`` (module docstring): a prefill expands its fresh compressed
    KV, a decode step runs absorbed over its block and combines the ranks'
    outputs by their log-sum-exp."""
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
    absorbed = S <= DECODE_DIRECT_MAX_Q and cache is not None
    blk = None if cache is None else _kv_block(cache, "c_kv")
    if blk is not None:
        # sharded: a prefill attends its fresh compressed KV, expanded; a
        # decode step its block, absorbed, then combines (module docstring)
        fresh = _write_block(cache, positions, blk, x.dtype, c_kv=c_kv,
                             k_rope=k_rope)
        c_kv, k_rope, pos_ids = fresh if S > 1 else (
            cache["c_kv"], cache["k_rope"], fresh[-1])
        absorbed = S == 1
    elif cache is not None:
        _write_cache(cache, positions, x.dtype, c_kv=c_kv, k_rope=k_rope)
        c_kv, k_rope, pos_ids = cache["c_kv"], cache["k_rope"], \
            cache["pos_ids"]

    if absorbed:
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
        l = p.sum(-1, keepdim=True)
        p = p / torch.clamp_min(l, 1e-20)
        out_c = torch.einsum("bshk,bkr->bshr", p, c_kv.float())
        out = torch.einsum("bshr,rhv->bshv", out_c.to(x.dtype), wv_b)
        if blk is not None:
            lse = torch.where(torch.isneginf(m), -math.inf, m + torch.log(l))
            out = combine_ranks(out, lse[..., 0].transpose(1, 2), blk[2])
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


def mlp(params, x: torch.Tensor, prefix: str = "",
        group: Optional[sh.TensorParallel] = None) -> torch.Tensor:
    """SwiGLU MLP.  ``group``: the model group whose rank's blocks the
    leaves are (w_gate / w_up columns, w_down rows: d_ff / n of the
    hidden width); the partial products are summed over it."""
    g = x @ params[prefix + "w_gate"].to(x.dtype)
    u = x @ params[prefix + "w_up"].to(x.dtype)
    return tp_output((F.silu(g) * u) @ params[prefix + "w_down"].to(x.dtype),
                     group)


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
                   cap: int, queue=queue_ranks) -> torch.Tensor:
    """Sort-based dispatch of xg [T, D] into an [E, cap, D] buffer, the
    experts, then the gate-weighted combine -> [T, D].  ``queue`` gives
    each (token, k) its place in its expert's queue (``queue_ranks``; a
    split batch's ``_queue_ranks_across``).

    A (token, k) past its expert's capacity goes to one spare row behind
    the buffer, which the experts never see (the reference's
    ``mode="drop"``): no out-of-range index, no host sync.  In-capacity
    slots are unique, so the scatter is deterministic.  The combine is a
    gather of [T, K, D] and a float32 sum over k, no scatter-add."""
    T, D = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    gates, experts = route(params["router"], xg, K)
    ranks = queue(experts)
    in_cap = ranks < cap
    slot = torch.where(in_cap, experts * cap + ranks, E * cap)
    xe = xg.new_zeros((E * cap + 1, D))
    xe[slot.reshape(-1)] = xg.repeat_interleave(K, 0)
    ye = _expert_ffn(params, xe[:-1].view(E, cap, D)).reshape(E * cap, D)
    ytk = ye[(experts * cap + ranks.clamp_max(cap - 1)).reshape(-1)]
    w = (gates * in_cap).to(ytk.dtype)
    y = torch.einsum("tkd,tk->td", ytk.reshape(T, K, D).float(), w.float())
    return y.to(xg.dtype)


def moe_ep(params, x: torch.Tensor, cfg: ArchConfig,
           t_local: Optional[int] = None) -> torch.Tensor:
    """The reference's expert-parallel MoE, one shard's body: the sort
    dispatch of its own B * S tokens with the capacity of ``t_local``
    tokens (default B * S: one device; the reference's whole batch over
    its data shards on a mesh), then the shared experts."""
    B, S, D = x.shape
    xg = x.reshape(B * S, D)
    y = moe_sort_group(params, xg, cfg, _capacity(
        cfg, B * S if t_local is None else t_local))
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


def _batch_share(B: int) -> Tuple[int, int, Tuple[str, ...]]:
    """(whole batch, this rank's first row, the mesh axes splitting the
    batch) of a rank's B rows: B, 0, () on one device or a mesh whose
    ``batch`` rule splits nothing; under a mesh that splits it, the batch
    a sharded serving step recorded (``parallel.sharding.step_fact``)."""
    if sh.rule_size("batch") == 1:
        return B, 0, ()
    whole = sh.step_fact("batch")
    if whole is None:
        raise ValueError("an MoE layer on a mesh that splits the batch "
                         "needs the whole batch: serve it through "
                         "serve.engine with a cache from serve.cache."
                         "zeros(..., mesh=mesh)")
    start, rows, axes = sh.dim_block("batch", whole)
    if rows != B:
        raise ValueError(f"{B} rows are not this rank's block of the "
                         f"batch of {whole} ({rows} rows)")
    return whole, start, axes


def _queue_ranks_across(experts: torch.Tensor, axes: Tuple[str, ...],
                        first: int) -> torch.Tensor:
    """``queue_ranks`` of this rank's experts [T, K] among the whole
    batch's: the ranks along ``axes`` hold consecutive blocks of its
    tokens, this rank's from token ``first``.  One all-gather of the
    routing (T x K indices a rank)."""
    every = sh.gather_ranks(experts, axes)                     # [n, T, K]
    T = experts.shape[0]
    return queue_ranks(every.reshape(-1, experts.shape[1]))[first:first + T]


def moe(params, x: torch.Tensor, cfg: ArchConfig,
        impl: str = "ep_sort") -> torch.Tensor:
    """Top-k MoE with capacity-based dispatch, x [B, S, D] -> [B, S, D];
    ``moe_plan`` of the whole batch says which path and capacity.  The
    shared experts are added after the sort and onehot paths (inside the
    expert-parallel one).

    A rank's block of a batch split over a mesh (``_batch_share``) keeps
    the reference's semantics: from ``MOE_EP_MIN_TOKENS`` tokens of the
    whole batch its expert-parallel shard takes the capacity of its share
    of them and queues its own tokens; below, the capacity counts the
    whole batch and each token queues behind every rank's earlier ones
    (``_queue_ranks_across``), as the reference's sort path over all
    tokens."""
    B, S, D = x.shape
    whole, first, axes = _batch_share(B)
    path, cap, chunk = moe_plan(cfg, whole, S, impl)
    if path == "ep":
        dp = sh.rule_size("batch")
        if axes and whole % dp:
            raise ValueError(f"a batch of {whole} split over some of its "
                             f"{dp} batch ranks: the expert-parallel MoE "
                             "takes it split over all or none")
        return moe_ep(params, x, cfg, whole * S // dp)
    if axes and path != "sort":
        raise ValueError(f"the {path} MoE path does not take a split batch")
    if path == "sort":
        queue = queue_ranks if not axes else (
            lambda e: _queue_ranks_across(e, axes, first * S))
        y = moe_sort_group(params, x.reshape(B * S, D), cfg, cap,
                           queue).reshape(B, S, D)
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
