"""Model assembly of the port (the reference's ``models/model.py``):
configs -> layer plan -> an ``nn.Module`` of per-layer blocks -> prefill /
decode forward passes.

The layer plan is the reference's (a list of groups, each a repeating unit
of block kinds).  The reference stacks a group's parameters along a
leading ``repeats`` axis and scans over it; the port keeps one
``ParamBlock`` per layer and runs a Python loop, without remat (serving
runs ``remat_policy="none"``).  The JAX package's ``shard(...)`` calls are
no-ops on one device and are dropped.

Runs the attention block kinds (``attn`` / ``attn_local`` /
``attn_global``), the MoE family's (``attn_moe``, and MLA's
``mla_dense`` / ``mla_moe``), the recurrent ones (xLSTM's ``mlstm`` /
``slstm``, ``models/ssm.py``) and hymba's hybrid ``hymba_local`` /
``hymba_global`` (attention and mamba side by side); the
encoder-decoder and the VLM patch stub raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.power import Device, resolve_device
from . import ssm
from .config import ArchConfig
from .layers import (Init, attention, init_attention, init_mla, init_mlp,
                     init_moe, leaf_dtype, mla_attention, mlp, moe, rms_norm,
                     softcap)
from .tree import tmap

ATTN_KINDS = ("attn", "attn_local", "attn_global")
MOE_KINDS = ("attn_moe", "mla_dense", "mla_moe")
SSM_KINDS = ("mlstm", "slstm")
HYBRID_KINDS = ("hymba_local", "hymba_global")
KINDS = ATTN_KINDS + MOE_KINDS + SSM_KINDS + HYBRID_KINDS
_TODO = "comes with its slice (ROADMAP Queue 1, item 8)"

# ---------------------------------------------------------------------------
# layer plan (copied from the reference)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerGroup:
    kinds: Tuple[str, ...]
    repeats: int


def _periodic_groups(kinds: Tuple[str, ...], max_period: int = 16
                     ) -> List[LayerGroup]:
    """Split a kind sequence into repeating units (smallest period <= cap)."""
    n = len(kinds)
    for p in range(1, min(max_period, n) + 1):
        if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
            return [LayerGroup(kinds=kinds[:p], repeats=n // p)]
    # fall back: split off a prefix until the remainder is periodic
    for cut in range(1, n):
        rest = _periodic_groups(kinds[cut:], max_period)
        if len(rest) == 1:
            return [LayerGroup(kinds=kinds[:cut], repeats=1)] + rest
    return [LayerGroup(kinds=kinds, repeats=1)]


def layer_plan(cfg: ArchConfig) -> List[LayerGroup]:
    """Decoder-side (or decoder-only) layer plan."""
    L = cfg.n_layers
    if cfg.family == "ssm" and cfg.block_pattern:
        return _periodic_groups(cfg.layer_kinds())
    if cfg.family == "hybrid":
        period = cfg.local_global_period or L
        kinds = tuple("hymba_global" if i % period == 0 else "hymba_local"
                      for i in range(L))
        return _periodic_groups(kinds)
    if cfg.use_mla:
        nd = cfg.first_dense_layers
        groups = []
        if nd:
            groups.append(LayerGroup(kinds=("mla_dense",) * nd, repeats=1))
        groups.append(LayerGroup(kinds=("mla_moe",), repeats=L - nd))
        return groups
    if cfg.moe:
        return [LayerGroup(kinds=("attn_moe",), repeats=L)]
    if cfg.is_encoder_decoder:
        return [LayerGroup(kinds=("dec_attn",), repeats=L)]
    if cfg.local_global_period:
        p = cfg.local_global_period
        kinds = tuple("attn_global" if i % p == (p - 1) else "attn_local"
                      for i in range(L))
        return _periodic_groups(kinds)
    return [LayerGroup(kinds=("attn",), repeats=L)]


def block_window(cfg: ArchConfig, kind: str) -> Optional[int]:
    """Static sliding window for a block kind (None = full attention)."""
    if kind in ("attn_local", "hymba_local"):
        return cfg.sliding_window or 4096
    if kind in ("attn_global", "hymba_global", "enc_attn", "dec_attn"):
        return None
    return cfg.sliding_window


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class ParamBlock(nn.Module):
    """One block's (or the model's top-level) parameters under the
    reference's leaf names; ``block["wq"]`` reads one."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class Model(nn.Module):
    """Parameters of one architecture: ``top`` holds embed / final_norm /
    lm_head, ``groups[gi][r]["b{j}"]`` the block of kind ``kinds[j]`` in
    repeat r of layer group gi (the reference's ``g{gi}`` leaves, one
    module per repeat)."""

    def __init__(self, cfg: ArchConfig, top: Mapping[str, torch.Tensor],
                 groups: List[List[Dict[str, Mapping[str, torch.Tensor]]]]):
        super().__init__()
        self.cfg = cfg
        self.top = ParamBlock(top)
        self.groups = nn.ModuleList(
            nn.ModuleList(nn.ModuleDict({name: ParamBlock(t)
                                         for name, t in unit.items()})
                          for unit in units)
            for units in groups)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.top[name]


def _torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} {_TODO}")


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder (cross-attention) {_TODO}")
    if cfg.vision_prefix_tokens:
        raise NotImplementedError(f"the VLM patch stub {_TODO}")
    for grp in layer_plan(cfg):
        for kind in grp.kinds:
            _check_kind(kind)


def _dense_ff(cfg: ArchConfig) -> int:
    # deepseek-v2's first (dense) layer uses a wider FFN than the per-expert
    # width; public config: 12288.  Everything else uses cfg.d_ff.
    if cfg.use_mla and cfg.moe:
        return 12288 if cfg.d_ff <= 2048 else cfg.d_ff
    return cfg.d_ff


def init_block(ini: Init, cfg: ArchConfig, kind: str) -> None:
    _check_kind(kind)
    if kind == "mlstm":
        return ssm.init_mlstm_block(ini, cfg)
    if kind == "slstm":
        return ssm.init_slstm_block(ini, cfg)
    D = cfg.d_model
    ini.mk("ln1", (D,), mode="zeros")
    if kind.startswith("mla"):
        init_mla(ini, cfg)
    elif kind in HYBRID_KINDS:
        init_attention(ini, cfg, prefix="attn_")
        ssm.init_mamba(ini, cfg, prefix="mamba_")
    else:
        init_attention(ini, cfg)
    ini.mk("ln2", (D,), mode="zeros")
    if kind in ("attn_moe", "mla_moe"):
        init_moe(ini, cfg)
    else:
        init_mlp(ini, D, _dense_ff(cfg), cfg.n_layers)


def apply_block(params, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                positions: torch.Tensor, cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One block of ``kind``; its cache slice (``serve.cache``) is
    written in place and returned."""
    _check_kind(kind)
    if kind == "mlstm":
        return x + ssm.mlstm_block(params, x, cfg, state=cache), cache
    if kind == "slstm":
        return x + ssm.slstm_block(params, x, cfg, state=cache), cache
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind in HYBRID_KINDS:
        # attention and mamba heads on the same input, mean-combined
        a, _ = attention(params, h, cfg, positions=positions,
                         cache=None if cache is None else cache["attn"],
                         window=block_window(cfg, kind), prefix="attn_")
        m = ssm.mamba(params, h, cfg,
                      state=None if cache is None else cache["mamba"],
                      prefix="mamba_")
        x = x + 0.5 * (a + m)
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        return x + mlp(params, h), cache
    if kind.startswith("mla"):
        a, new_cache = mla_attention(params, h, cfg, positions=positions,
                                     cache=cache)
    else:
        a, new_cache = attention(params, h, cfg, positions=positions,
                                 cache=cache, window=block_window(cfg, kind))
    x = x + a
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    ff = moe(params, h, cfg) if kind in ("attn_moe", "mla_moe") \
        else mlp(params, h)
    return x + ff, new_cache


def init_model(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
               *, device: Device = None) -> Model:
    """Random weights with the reference's scales (normal 1/sqrt(fan_in),
    the ``wo`` / ``w_down`` depth scales, embed 0.02, zero norms), drawn
    layer by layer on ``device`` from ``generator`` (a generator on that
    device; default: one seeded with 0).  Matrices are made in
    ``cfg.dtype`` and drawn in float32 one tensor at a time, so the float32
    transient is one weight, never the model.  ``device="meta"``
    allocates nothing (shapes only).  The draws are not the JAX package's:
    carry its weights across with ``params_from_numpy`` to compare."""
    _check_supported(cfg)
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = _torch_dtype(cfg.dtype)
    top = Init(generator, dev, dt)
    top.mk("embed", (cfg.vocab, cfg.d_model), scale=0.02)
    top.mk("final_norm", (cfg.d_model,), mode="zeros")
    if not cfg.tie_embeddings:
        top.mk("lm_head", (cfg.d_model, cfg.vocab),
               scale=1.0 / math.sqrt(cfg.d_model))
    groups = []
    for grp in layer_plan(cfg):
        units = []
        for _ in range(grp.repeats):
            unit = {}
            for j, kind in enumerate(grp.kinds):
                blk = Init(generator, dev, dt)
                init_block(blk, cfg, kind)
                unit[f"b{j}"] = blk.params
            units.append(unit)
        groups.append(units)
    return Model(cfg, top.params, groups)


def params_from_numpy(cfg: ArchConfig, tree: Mapping, *,
                      device: Device = None) -> Model:
    """The port's model from the JAX package's parameter tree (leaves as
    numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``).

    Each ``g{gi}`` leaf carries a leading ``repeats`` axis (the
    reference's group stacking); repeat r becomes the r-th per-layer
    module (expert weights ``[repeats, E, D, F]`` become ``[E, D, F]``).
    Matrices are cast once to ``cfg.dtype``, where the reference casts
    each weight to the activation dtype at every use: the numbers are the
    same.  Leaves stay float32 where ``layers.leaf_dtype`` says (1-D norm
    scales and biases, ``A_log``, sLSTM's ``r*``), as ``init_model`` makes
    them."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = _torch_dtype(cfg.dtype)

    def conv(name: str, a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=leaf_dtype(name, t.dim(), dt))

    top = {k: conv(k, tree[k]) for k in ("embed", "final_norm", "lm_head")
           if k in tree}
    groups = []
    for gi, grp in enumerate(layer_plan(cfg)):
        gtree = tree[f"g{gi}"]
        units = []
        for r in range(grp.repeats):
            units.append({f"b{j}": {name: conv(name, np.asarray(a)[r])
                                    for name, a in gtree[f"b{j}"].items()}
                          for j in range(len(grp.kinds))})
        groups.append(units)
    return Model(cfg, top, groups)


def param_count(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# stack application
# ---------------------------------------------------------------------------


def apply_stack(model: Model, x: torch.Tensor, cfg: ArchConfig,
                plan: List[LayerGroup], *, positions: torch.Tensor,
                caches: Optional[List] = None
                ) -> Tuple[torch.Tensor, Optional[List]]:
    """Run x through all layer groups, one layer at a time.  ``caches``
    (``serve.cache.zeros``) is a per-group list whose leaves carry the
    group's ``repeats`` axis first; each layer reads and writes its slice
    (the whole tree of views: hymba's ``{attn, mamba}``, mLSTM's ``cell``
    tuple) in place, and the same list comes back."""
    for gi, grp in enumerate(plan):
        gcache = None if caches is None else caches[gi]
        for r, unit in enumerate(model.groups[gi]):
            for j, kind in enumerate(grp.kinds):
                c = None if gcache is None else tmap(
                    lambda buf: buf[r], gcache[f"b{j}"])
                x, _ = apply_block(unit[f"b{j}"], x, cfg, kind,
                                   positions=positions, cache=c)
    return x, caches


# ---------------------------------------------------------------------------
# embeddings, logits, forward
# ---------------------------------------------------------------------------


def embed_tokens(model: Model, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return model["embed"].to(_torch_dtype(cfg.dtype))[tokens.long()]


def logits_fn(model: Model, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, model["final_norm"], cfg.norm_eps)
    w = model["embed"].T if cfg.tie_embeddings else model["lm_head"]
    logits = h @ w.to(h.dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)


def _positions(n: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


@torch.no_grad()
def forward_hidden(model: Model, cfg: ArchConfig, batch: Dict) -> torch.Tensor:
    """Final hidden states [B, S, D] of a tokens batch, no cache."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(model, cfg, tokens)
    x, _ = apply_stack(model, x, cfg, layer_plan(cfg),
                       positions=_positions(tokens.shape[1], x.device))
    return x
