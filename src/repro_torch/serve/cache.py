"""Decode-state (KV cache / recurrent state) specifications of the port
(the reference's ``serve/cache.py``).

Caches mirror the layer plan: a list with one entry per layer group, each a
dict ``{"b{j}": leaves}`` whose leaves carry the group's ``repeats`` axis
first.  Leaves are ``TSpec``s carrying shape, dtype and the reference's
*logical* sharding axes (the stacked ``repeats`` axis None), so the same
spec tree yields
  * ``zeros``      -- tensors on a device: the whole tree, or under a mesh
                      the rank's block of each leaf (real serving), in
                      ``Blocks``, which keeps the whole tree's spec;
  * ``sds``        -- ``meta`` tensors of the whole shapes (the port's
                      ``ShapeDtypeStruct``);
  * ``shardings``  -- each leaf's spec on a mesh (``parallel.sharding.
                      logical_spec``): ``batch`` -> ("pod", "data"),
                      ``kv_seq`` -> "model", an axis that does not divide
                      its dimension dropped.
Attention K/V, MLA's compressed KV and whisper's cross K/V lie along
``("batch", "kv_seq", ...)``; position ids ``(None,)`` stay whole on every
rank.  The recurrent states' ``heads`` / ``tp`` dimensions resolve to
"model" in ``shardings`` (the reference's layout), but the port computes
the recurrent blocks whole on every model rank (their split is ROADMAP
item 12b), so ``zeros`` keeps those dimensions whole (``held_spec``).
The attention caches hold every kv head on each rank: tensor-parallel
serving gathers a step's fresh K/V along the heads before the write.

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
from ..parallel import sharding as sh

__all__ = ["TSpec", "Blocks", "tmap", "zeros", "sds", "shardings",
           "held_spec", "whole_sizes", "block_cache_spec", "cache_spec",
           "cache_bytes", "leaves"]

# logical axes the port computes whole on every model rank (the recurrent
# blocks; ROADMAP item 12b): ``zeros`` keeps the cache dimensions they
# name whole
WHOLE_ON_MODEL_RANKS = ("heads", "tp")


@dataclass(frozen=True)
class TSpec:
    shape: Tuple[int, ...]
    dtype: Any
    axes: Tuple


def sds(tree):
    """``meta`` tensors of a spec tree's whole shapes and dtypes."""
    return tmap(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                tree)


def shardings(tree, mesh):
    """Each leaf's spec on ``mesh`` (a ``DeviceMesh`` or a mapping of axis
    sizes): its logical axes through ``parallel.sharding.logical_spec``."""
    return tmap(lambda s: sh.logical_spec(s.axes, s.shape, mesh), tree)


def held_spec(s: TSpec, mesh) -> sh.Spec:
    """The spec of the block a rank holds of leaf ``s`` on ``mesh``:
    ``shardings``' with the dimensions of ``WHOLE_ON_MODEL_RANKS`` whole."""
    axes = tuple(None if a in WHOLE_ON_MODEL_RANKS else a for a in s.axes)
    return sh.logical_spec(axes, s.shape, mesh)


class Blocks(list):
    """A rank's blocks of a cache tree (``zeros(..., mesh=...)``): the
    per-group list, with the whole tree's ``spec``, from which a sharded
    step reads the sizes the blocks were cut from (``whole_sizes``)."""
    spec = None


def whole_sizes(tree) -> Dict[str, int]:
    """The whole sizes of a cache spec tree that its blocks cannot tell:
    the ``batch`` every leaf's batch dimension holds, and ``enc_len``, the
    encoder length of the cross caches, where there are any."""
    out = {}
    for grp in tree:
        for blk in grp.values():
            for s in leaves(blk):
                if "batch" in s.axes:
                    out["batch"] = s.shape[s.axes.index("batch")]
            if "cross" in blk:
                k = blk["cross"]["k"]
                out["enc_len"] = k.shape[k.axes.index("kv_seq")]
    return out


def zeros(tree, device: Device = None, mesh=None):
    """Tensors for a spec tree on ``device`` (default CUDA): zeros, and
    position ids filled with -1 (unwritten).  With ``mesh`` (a
    ``DeviceMesh``, or a mapping of axis sizes standing for its rank 0)
    each leaf is this rank's block (``held_spec``), in ``Blocks``."""
    dev = torch.device("meta") if device == "meta" else resolve_device(
        device)

    def one(s: TSpec):
        shape = s.shape
        if mesh is not None:
            shape = tuple(b.stop - b.start for b in sh.block(
                held_spec(s, mesh), s.shape, sh.mesh_shape(mesh),
                sh.coordinate(mesh)))
        if s.dtype == torch.int32:
            return torch.full(shape, -1, dtype=torch.int32, device=dev)
        return torch.zeros(shape, dtype=s.dtype, device=dev)
    if mesh is None:
        return tmap(one, tree)
    out = Blocks(tmap(one, tree))
    out.spec = tree
    return out


def _attn_spec(cfg: ArchConfig, B: int, smax: int, dtype) -> Dict:
    KH, Dh = cfg.n_kv_heads, cfg.head_dim
    kv = ("batch", "kv_seq", None, None)
    return dict(k=TSpec((B, smax, KH, Dh), dtype, kv),
                v=TSpec((B, smax, KH, Dh), dtype, kv),
                pos_ids=TSpec((smax,), torch.int32, (None,)))


def _mla_spec(cfg: ArchConfig, B: int, smax: int, dtype) -> Dict:
    kv = ("batch", "kv_seq", None)
    return dict(c_kv=TSpec((B, smax, cfg.kv_lora_rank), dtype, kv),
                k_rope=TSpec((B, smax, cfg.rope_head_dim), dtype, kv),
                pos_ids=TSpec((smax,), torch.int32, (None,)))


def _mlstm_spec(cfg: ArchConfig, B: int) -> Dict:
    Din = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    dqk, dv = Din // H // 2, Din // H
    f32 = torch.float32
    return dict(conv=TSpec((B, cfg.conv_kernel - 1, Din), f32,
                           ("batch", None, "tp")),
                cell=(TSpec((B, H, dqk, dv), f32,
                            ("batch", "heads", None, None)),
                      TSpec((B, H, dqk), f32, ("batch", "heads", None)),
                      TSpec((B, H), f32, ("batch", "heads"))))


def _slstm_spec(cfg: ArchConfig, B: int) -> Dict:
    H = cfg.n_heads
    t = TSpec((B, H, cfg.d_model // H), torch.float32,
              ("batch", "heads", None))
    return dict(h=t, c=t, n=t, m=t)


def _mamba_spec(cfg: ArchConfig, B: int) -> Dict:
    Din = cfg.ssm_expand * cfg.d_model
    return dict(conv=TSpec((B, cfg.conv_kernel - 1, Din), torch.float32,
                           ("batch", None, "tp")),
                h=TSpec((B, Din, cfg.ssm_state), torch.float32,
                        ("batch", "tp", None)))


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
        cross = TSpec((B, enc_len, cfg.n_kv_heads, cfg.head_dim), dtype,
                      ("batch", "kv_seq", None, None))
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
        out.append(tmap(lambda s: TSpec((grp.repeats,) + s.shape, s.dtype,
                                        (None,) + s.axes), unit))
    return out


def cache_bytes(spec: List) -> int:
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype)
               .element_size() for s in leaves(spec))
