"""Model assembly of the port (the reference's ``models/model.py``):
configs -> layer plan -> an ``nn.Module`` of per-layer blocks -> prefill /
decode forward passes.

The layer plan is the reference's (a list of groups, each a repeating unit
of block kinds).  The reference stacks a group's parameters along a
leading ``repeats`` axis and scans over it; the port keeps one
``ParamBlock`` per layer and runs a Python loop.  Serving runs under
``torch.no_grad`` and never rematerializes; under grad each block is
checkpointed by the config's ``remat_policy`` (the reference's ``_remat``).
The JAX package's ``shard(...)`` activation constraints are dropped in
training: the port's sharded train step (``train/step.py``) shards the
parameters and optimizer state by each leaf's logical axes
(``Model.axes``, the reference's tuples without its stacked ``repeats``
axis) and all-gathers a leaf's compute copy whole, so its activations
are never sharded.  Serving on a mesh computes tensor-parallel over the
"model" axis (``serve/engine.py``): the attention and dense-MLP
families' constraints become each activation's layout on its rank
(``models/layers.py``), and ``cross_attention``, ``embed_tokens`` (a
masked lookup of the rank's vocabulary rows, all-reduced) and
``logits_fn`` (the rank's vocabulary block, all-gathered) follow the
reference's ``model.py:248``, ``:404`` and ``:413``; ``tp_leaves`` names
the leaves read as the rank's blocks.

Training (``forward_train``, ``xent_loss``) holds float32 masters
(``init_model`` / ``params_from_numpy`` with ``trainable=True``) and, as
the reference's train step does, differentiates a copy of every float32
leaf cast to the compute dtype once a step (``compute_view``): a
``ParamView`` with the model's access pattern, so the model functions run
on either.

Runs every block kind of the reference: attention (``attn`` /
``attn_local`` / ``attn_global``), the MoE family's (``attn_moe``, and
MLA's ``mla_dense`` / ``mla_moe``), the recurrent ones (xLSTM's
``mlstm`` / ``slstm``, ``models/ssm.py``), hymba's hybrid
``hymba_local`` / ``hymba_global`` (attention and mamba side by side) and
whisper's encoder-decoder pair (``enc_attn``, non-causal; ``dec_attn``,
causal self-attention then cross-attention over the encoder's states).
The stub front ends are the reference's: whisper's encoder takes frame
embeddings ``batch["frames"]`` [B, S_enc, D], internvl2's decoder
prepends patch embeddings ``batch["patches"]`` [B, P, D] to its tokens.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.power import Device, resolve_device
from ..kernels import flash_attention as fa
from ..parallel import sharding as sh
from . import layers as L
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
ENC_DEC_KINDS = ("enc_attn", "dec_attn")
KINDS = ATTN_KINDS + MOE_KINDS + SSM_KINDS + HYBRID_KINDS + ENC_DEC_KINDS

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


def encoder_plan(cfg: ArchConfig) -> List[LayerGroup]:
    if not cfg.is_encoder_decoder:
        return []
    return [LayerGroup(kinds=("enc_attn",), repeats=cfg.encoder_layers)]


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

    def __init__(self, tensors: Mapping[str, torch.Tensor],
                 requires_grad: bool = False):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(
                t, requires_grad=requires_grad))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


Units = List[List[Dict[str, Mapping[str, torch.Tensor]]]]


def _stack_modules(groups: Units, requires_grad: bool) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ModuleList(nn.ModuleDict({name: ParamBlock(t, requires_grad)
                                     for name, t in unit.items()})
                      for unit in units)
        for units in groups)


class Model(nn.Module):
    """Parameters of one architecture: ``top`` holds embed / final_norm /
    lm_head (and the encoder's ``enc_final_norm``), ``groups[gi][r]["b{j}"]``
    the block of kind ``kinds[j]`` in repeat r of layer group gi (the
    reference's ``g{gi}`` leaves, one module per repeat), ``enc_groups``
    the encoder's the same way (its ``enc_g{gi}`` leaves; empty but for
    an encoder-decoder).  ``requires_grad``: trainable leaves (training's
    float32 masters); serving's stay frozen.  ``axes``: each leaf's
    logical axes by its ``named_parameters`` name (the reference's
    ``init_model(...)[1]`` without the stacked ``repeats`` axis)."""

    def __init__(self, cfg: ArchConfig, top: Mapping[str, torch.Tensor],
                 groups: Units, enc_groups: Units = (),
                 requires_grad: bool = False):
        super().__init__()
        self.cfg = cfg
        self.top = ParamBlock(top, requires_grad)
        self.groups = _stack_modules(groups, requires_grad)
        self.enc_groups = _stack_modules(enc_groups, requires_grad)
        self.axes = leaf_axes(cfg)
        if list(self.axes) != [n for n, _ in self.named_parameters()]:
            raise ValueError(f"{cfg.name}: the leaves are not init_model's")

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.top[name]


class ParamView:
    """Read-only stand-in for a ``Model`` over other tensors: ``top`` leaves
    by name (``view["embed"]``), ``groups`` / ``enc_groups`` as nested
    lists of per-layer ``{"b{j}": {leaf: tensor}}``, the access the model
    functions use.  ``tensor_parallel``: the leaves of ``tp_leaves`` are
    a model rank's blocks (``serve.engine.gathered_view``)."""

    def __init__(self, cfg: ArchConfig, top: Dict[str, torch.Tensor],
                 groups: List, enc_groups: List,
                 tensor_parallel: bool = False):
        self.cfg, self.top = cfg, top
        self.groups, self.enc_groups = groups, enc_groups
        self.tensor_parallel = tensor_parallel

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.top[name]


def compute_view(model: Model, dtype: Optional[torch.dtype],
                 leaf: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None):
    """The copy a train step differentiates (the reference's ``cast`` in
    ``train/step.py``): every float32 leaf cast to ``dtype`` -- 1-D norms,
    ``A_log`` and sLSTM's ``r*`` too -- once, in the autograd graph, so
    gradients reach the float32 masters through the cast.  ``dtype=None``:
    the model itself, uncast.  ``leaf(p)``, when given, makes each leaf's
    compute copy instead: the sharded step's all-gather of a master's
    shard (``train.step``), the one place a leaf is gathered whole."""
    if dtype is None and leaf is None:
        return model
    if leaf is None:
        leaf = lambda p: p.to(dtype) if p.dtype == torch.float32 else p

    def cast(blk: ParamBlock) -> Dict[str, torch.Tensor]:
        return {name: leaf(p) for name, p in blk.named_parameters()}

    def stack(groups: nn.ModuleList) -> List:
        return [[{b: cast(blk) for b, blk in unit.items()} for unit in units]
                for units in groups]

    return ParamView(model.cfg, cast(model.top), stack(model.groups),
                     stack(model.enc_groups))


def _torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def init_top(ini: Init, cfg: ArchConfig) -> None:
    """The top-level leaves: embed, final_norm, lm_head unless tied, and
    an encoder-decoder's enc_final_norm (zeros: nothing drawn)."""
    ini.mk("embed", (cfg.vocab, cfg.d_model), ("tp", "fsdp"), scale=0.02)
    ini.mk("final_norm", (cfg.d_model,), (None,), mode="zeros")
    if not cfg.tie_embeddings:
        ini.mk("lm_head", (cfg.d_model, cfg.vocab), ("fsdp", "tp"),
               scale=1.0 / math.sqrt(cfg.d_model))
    if cfg.is_encoder_decoder:
        ini.mk("enc_final_norm", (cfg.d_model,), (None,), mode="zeros")


def _axes_of(make) -> Dict[str, Tuple]:
    """The leaves' logical axes, in order, of ``make(ini)`` run on an
    ``Init`` on the meta device (nothing allocated)."""
    ini = Init(None, torch.device("meta"), torch.float32)
    make(ini)
    return ini.axes


def _block_axes(cfg: ArchConfig, kind: str) -> Dict[str, Tuple]:
    return _axes_of(lambda ini: init_block(ini, cfg, kind))


def leaf_axes(cfg: ArchConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of every leaf by its ``Model.named_parameters`` name
    (``top.embed``, ``groups.0.3.b0.wq``, ...), in that order."""
    out = {f"top.{k}": a for k, a in _axes_of(
        lambda ini: init_top(ini, cfg)).items()}
    for tag, plan in (("groups", layer_plan(cfg)),
                      ("enc_groups", encoder_plan(cfg))):
        for gi, grp in enumerate(plan):
            kinds = [_block_axes(cfg, kind) for kind in grp.kinds]
            for r in range(grp.repeats):
                for j, blk in enumerate(kinds):
                    out.update({f"{tag}.{gi}.{r}.b{j}.{k}": a
                                for k, a in blk.items()})
    return out


def tp_leaves(cfg: ArchConfig, n: int) -> set:
    """The leaves (``Model.named_parameters`` names) that tensor-parallel
    serving on a model group of ``n`` ranks reads as the rank's block
    along their ``tp`` dimension -- the split ``attention``, ``mlp``,
    ``cross_attention``, ``embed_tokens`` and ``logits_fn`` compute on
    (``parallel.sharding.tp_of``): an attention's wq / wo where n divides
    the heads, its wk / wv where n divides the kv heads (a cross
    attention's never: its cache holds every kv head), a dense MLP's
    w_gate / w_up / w_down where n divides d_ff, embed and lm_head where n
    divides the vocabulary.  MLA, the MoE (experts and shared expert) and
    the recurrent blocks compute whole: their leaves are none of these."""
    H, KH, ff = cfg.n_heads, cfg.n_kv_heads, _dense_ff(cfg)
    top = {"top.embed", "top.lm_head"} if cfg.vocab % n == 0 else set()

    def block(kind: str) -> set:
        out = set()
        attn = {"": kind in ATTN_KINDS + ("attn_moe", "enc_attn",
                                          "dec_attn"),
                "attn_": kind in HYBRID_KINDS, "x_": kind == "dec_attn"}
        for prefix, has in attn.items():
            if has and H % n == 0:
                out |= {prefix + "wq", prefix + "wo"}
                if KH % n == 0 and prefix != "x_":
                    out |= {prefix + "wk", prefix + "wv"}
        if kind not in ("attn_moe", "mla_moe", "mlstm", "slstm") \
                and ff % n == 0:
            out |= {"w_gate", "w_up", "w_down"}
        return out

    plans = {"groups": layer_plan(cfg), "enc_groups": encoder_plan(cfg)}
    names = set()
    for name in leaf_axes(cfg):
        parts = name.split(".")
        if parts[0] == "top":
            names |= top & {name}
        elif parts[4] in block(plans[parts[0]][int(parts[1])]
                               .kinds[int(parts[3][1:])]):
            names.add(name)
    return names


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
    ini.mk("ln1", (D,), (None,), mode="zeros")
    if kind.startswith("mla"):
        init_mla(ini, cfg)
    elif kind in HYBRID_KINDS:
        init_attention(ini, cfg, prefix="attn_")
        ssm.init_mamba(ini, cfg, prefix="mamba_")
    else:
        init_attention(ini, cfg)
    if kind == "dec_attn":
        ini.mk("ln_x", (D,), (None,), mode="zeros")
        init_attention(ini, cfg, prefix="x_")   # cross-attention
    ini.mk("ln2", (D,), (None,), mode="zeros")
    if kind in ("attn_moe", "mla_moe"):
        init_moe(ini, cfg)
    else:
        init_mlp(ini, D, _dense_ff(cfg), cfg.n_layers)


def apply_block(params, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                positions: torch.Tensor, cache: Optional[Dict] = None,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One block of ``kind``; its cache slice (``serve.cache``) is
    written in place and returned.  ``enc_out``: the encoder's states,
    which ``dec_attn`` attends at prefill (None at decode, where it reads
    their projections from its cross cache)."""
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
        return x + mlp(params, h, group=sh.tp_of(_dense_ff(cfg))), cache
    if kind == "dec_attn":
        a, _ = attention(params, h, cfg, positions=positions,
                         cache=None if cache is None else cache["self"])
        x = x + a
        h = rms_norm(x, params["ln_x"], cfg.norm_eps)
        x = x + cross_attention(params, h, cfg, enc_out=enc_out,
                                cache=None if cache is None
                                else cache["cross"])
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        return x + mlp(params, h, group=sh.tp_of(_dense_ff(cfg))), cache
    if kind.startswith("mla"):
        a, new_cache = mla_attention(params, h, cfg, positions=positions,
                                     cache=cache)
    else:
        a, new_cache = attention(params, h, cfg, positions=positions,
                                 cache=cache, window=block_window(cfg, kind),
                                 causal=kind != "enc_attn")
    x = x + a
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    ff = moe(params, h, cfg) if kind in ("attn_moe", "mla_moe") \
        else mlp(params, h, group=sh.tp_of(_dense_ff(cfg)))
    return x + ff, new_cache


def cross_attention(params, x: torch.Tensor, cfg: ArchConfig, *,
                    enc_out: Optional[torch.Tensor], cache: Optional[Dict],
                    prefix: str = "x_") -> torch.Tensor:
    """Encoder-decoder cross-attention (the reference's): x [B, S, D] over
    the encoder's states, no rope, no qk-norm, non-causal (query positions
    all 0, so only unwritten slots could mask).  With ``enc_out``
    (prefill) K/V are projected from it and, given a cache ``{"k", "v"
    [B, S_enc, KH, Dh]}``, written into it in place; without (decode) they
    are read from the cache.  CUDA tensors launch the flash-attention
    kernel; CPU tensors run the chunked plain version (its default chunk,
    the reference's) at every Sq, as the reference calls it.

    Under a mesh whose ``kv_seq`` rule splits the cross cache
    (``models/layers.py``'s sharded serving), prefill writes this rank's
    block of the projected K/V and attends them whole; decode attends the
    rank's block and combines the model ranks' outputs by log-sum-exp.
    The block alone does not tell whether the rule split the encoder's
    length or kept it whole (a length the model axis does not divide):
    decode reads the length the engine recorded for the step
    (``parallel.sharding.step_fact("enc_len")``) and combines only where
    the rule split it."""
    B, S, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = lambda name: params[prefix + name].to(x.dtype)
    g, h0, Hq = L.head_share(H)
    q = (x @ w("wq")).reshape(B, S, Hq, Dh)
    q_pos = torch.zeros(S, dtype=torch.int32, device=x.device)
    # the kv heads the rank's query heads read (the cache holds all KH)
    sel = (lambda t: t) if g is None else \
        (lambda t: L.kv_for_heads(t, h0, Hq, H // KH))
    if enc_out is None:
        if cache is None:
            raise ValueError("cross attention needs enc_out or a cache")
        k, v = cache["k"], cache["v"]
        # under a mesh that splits kv_seq the cache may be this rank's
        # block: attend it and combine the model ranks' outputs
        n = k.shape[1] if sh.rule_size("kv_seq") == 1 \
            else sh.step_fact("enc_len")
        if n is None:
            raise ValueError("a cross cache on a mesh that splits kv_seq "
                             "needs its encoder length: serve it through "
                             "serve.engine with a cache from serve.cache."
                             "zeros(..., mesh=mesh)")
        start, width, axes = sh.dim_block("kv_seq", n)
        if width != k.shape[1]:
            raise ValueError(f"cross cache of {k.shape[1]} slots; its "
                             f"block of {n} under the mesh is {width}")
        if axes:
            # every query head on the rank's slots, then its own heads
            q_all = q if g is None else L.gather_heads(g, q)[0]
            out = L.combine_ranks(*fa.attend_lse(
                q_all, k, v, q_pos, _positions(width, x.device, start),
                causal=False), axes)[:, :, h0:h0 + Hq]
            out = out.to(x.dtype).reshape(B, S, Hq * Dh)
            return L.tp_output(out @ w("wo"), g)
    else:
        k = (enc_out @ w("wk")).reshape(B, -1, KH, Dh)
        v = (enc_out @ w("wv")).reshape(B, -1, KH, Dh)
        if cache is not None:
            start, width, _ = sh.dim_block("kv_seq", k.shape[1])
            held = (B, width, KH, Dh)
            if tuple(cache["k"].shape) != held or cache["k"].dtype != k.dtype:
                raise ValueError(
                    f"cross cache {tuple(cache['k'].shape)} "
                    f"{cache['k'].dtype} does not hold the encoder's K/V "
                    f"{held} {k.dtype}")
            cache["k"].copy_(k[:, start:start + width])
            cache["v"].copy_(v[:, start:start + width])
    kv_pos = _positions(k.shape[1], x.device)
    out = fa.attend(q, sel(k), sel(v), q_pos, kv_pos, causal=False,
                    plain=fa.flash_attention)
    out = out.to(x.dtype).reshape(B, S, Hq * Dh)
    return L.tp_output(out @ w("wo"), g)


def _build_units(plan: List[LayerGroup], make_block) -> Units:
    """Per-layer parameter dicts of a layer plan: ``make_block(gi, r, j,
    kind)`` gives block j of repeat r of group gi."""
    return [[{f"b{j}": make_block(gi, r, j, kind)
              for j, kind in enumerate(grp.kinds)}
             for r in range(grp.repeats)]
            for gi, grp in enumerate(plan)]


def init_model(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
               *, device: Device = None, trainable: bool = False) -> Model:
    """Random weights with the reference's scales (normal 1/sqrt(fan_in),
    the ``wo`` / ``w_down`` depth scales, embed 0.02, zero norms), drawn
    layer by layer on ``device`` from ``generator`` (a generator on that
    device; default: one seeded with 0): the decoder's layers, then an
    encoder-decoder's encoder layers, as the reference orders them.
    Matrices are made in ``cfg.dtype`` and drawn in float32 one tensor at
    a time, so the float32 transient is one weight, never the model.
    ``device="meta"`` allocates nothing (shapes only).  The draws are not
    the JAX package's: carry its weights across with ``params_from_numpy``
    to compare.  ``trainable``: every leaf a float32 master that requires
    grad (the reference's ``init_model``; the same draws)."""
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = torch.float32 if trainable else _torch_dtype(cfg.dtype)
    top = Init(generator, dev, dt)
    init_top(top, cfg)

    def make_block(gi, r, j, kind):
        blk = Init(generator, dev, dt)
        init_block(blk, cfg, kind)
        return blk.params

    groups = _build_units(layer_plan(cfg), make_block)
    enc_groups = _build_units(encoder_plan(cfg), make_block)
    return Model(cfg, top.params, groups, enc_groups, trainable)


def params_from_numpy(cfg: ArchConfig, tree: Mapping, *,
                      device: Device = None,
                      trainable: bool = False) -> Model:
    """The port's model from the JAX package's parameter tree (leaves as
    numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``).

    Each ``g{gi}`` (and an encoder's ``enc_g{gi}``) leaf carries a leading
    ``repeats`` axis (the reference's group stacking); repeat r becomes
    the r-th per-layer module (expert weights ``[repeats, E, D, F]``
    become ``[E, D, F]``).  Matrices are cast once to ``cfg.dtype``, where
    the reference casts each weight to the activation dtype at every use:
    the numbers are the same.  Leaves stay float32 where
    ``layers.leaf_dtype`` says (1-D norm scales and biases, ``A_log``,
    sLSTM's ``r*``), as ``init_model`` makes them.  ``trainable``: every
    leaf a float32 master that requires grad, as the reference keeps its
    parameters."""
    dev = resolve_device(device)
    dt = torch.float32 if trainable else _torch_dtype(cfg.dtype)

    def conv(name: str, a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=leaf_dtype(name, t.dim(), dt))

    def carry(tag: str):
        def block(gi, r, j, kind):
            # init_model's leaf order: a config's models share one order
            leaves = tree[f"{tag}{gi}"][f"b{j}"]
            return {name: conv(name, np.asarray(leaves[name])[r])
                    for name in _block_axes(cfg, kind)}
        return block

    top = {k: conv(k, tree[k]) for k in ("embed", "final_norm", "lm_head",
                                         "enc_final_norm") if k in tree}
    return Model(cfg, top, _build_units(layer_plan(cfg), carry("g")),
                 _build_units(encoder_plan(cfg), carry("enc_g")), trainable)


def replace_parameters(module: nn.Module, tensors) -> None:
    """Put ``tensors`` (one a leaf, in ``named_parameters`` order) in place
    of ``module``'s parameters, each keeping its ``requires_grad``."""
    named = list(module.named_parameters())
    tensors = list(tensors)
    if len(tensors) != len(named):
        raise ValueError(f"{len(tensors)} tensors for {len(named)} leaves")
    for (name, p), t in zip(named, tensors):
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf,
                nn.Parameter(t, requires_grad=p.requires_grad))


def param_count(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# stack application
# ---------------------------------------------------------------------------

# the matrix products "dots" remat saves (jax.checkpoint_policies.
# checkpoint_dots): everything else in a block is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_POLICIES = ("full", "dots", "none")


def _remat(fn, policy: str):
    """The reference's ``_remat``, per block: "full" recomputes the whole
    block in the backward (only its inputs are kept), "dots" keeps the
    matrix products' outputs and recomputes the rest, "none" keeps every
    activation.  Without grad (serving) ``fn`` runs as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of "
                         f"{REMAT_POLICIES}")
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    return functools.partial(checkpoint, fn, use_reentrant=False)


def apply_stack(model: Model, x: torch.Tensor, cfg: ArchConfig,
                plan: List[LayerGroup], *, positions: torch.Tensor,
                caches: Optional[List] = None,
                enc_out: Optional[torch.Tensor] = None,
                tag: str = "g") -> Tuple[torch.Tensor, Optional[List]]:
    """Run x through all layer groups of ``plan``, one layer at a time:
    the decoder's (``tag`` "g", ``model.groups``) or the encoder's
    ("enc_g", ``model.enc_groups``), as the reference's tags name them.
    ``enc_out`` goes to every block.  ``caches`` (``serve.cache.zeros``) is
    a per-group list whose leaves carry the group's ``repeats`` axis
    first; each layer reads and writes its slice (the whole tree of views:
    hymba's ``{attn, mamba}``, whisper's ``{self, cross}``, mLSTM's
    ``cell`` tuple) in place, and the same list comes back.  ``model`` may
    be a ``ParamView``.  Under grad each block is rematerialized by the
    config's ``remat_policy`` (``_remat``)."""
    stack = {"g": model.groups, "enc_g": model.enc_groups}[tag]
    for gi, grp in enumerate(plan):
        gcache = None if caches is None else caches[gi]
        for r, unit in enumerate(stack[gi]):
            for j, kind in enumerate(grp.kinds):
                c = None if gcache is None else tmap(
                    lambda buf: buf[r], gcache[f"b{j}"])
                block = functools.partial(apply_block, cfg=cfg, kind=kind,
                                          positions=positions, cache=c)
                x, _ = _remat(block, cfg.remat_policy)(unit[f"b{j}"], x,
                                                       enc_out=enc_out)
    return x, caches


# ---------------------------------------------------------------------------
# embeddings, logits, forward
# ---------------------------------------------------------------------------


def embed_tokens(model: Model, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings.  Where the model group splits the
    vocabulary, ``embed`` is the rank's rows: a lookup of the tokens it
    holds, zeros for the others, summed over the group (one rank holds
    each token, so the sum is exact)."""
    embed = model["embed"].to(_torch_dtype(cfg.dtype))
    g = sh.tp_of(cfg.vocab)
    if g is None:
        return embed[tokens.long()]
    start, width = g.block(cfg.vocab)
    local = tokens.long() - start
    held = (local >= 0) & (local < width)
    x = torch.where(held[..., None], embed[local.clamp(0, width - 1)], 0.0)
    return sh.all_reduce(x.to(embed.dtype), g.axes)


def logits_fn(model: Model, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Float32 logits [..., V] of final states ``h``.  Where the model group
    splits the vocabulary (the reference's ``shard(logits, ..., "vocab")``)
    the rank computes its rows' block of the vocabulary (``embed`` tied or
    ``lm_head``: the rank's block either way) and the blocks are
    all-gathered along the vocabulary, which the engine returns and takes
    its argmax over."""
    h = rms_norm(h, model["final_norm"], cfg.norm_eps)
    w = model["embed"].T if cfg.tie_embeddings else model["lm_head"]
    logits = softcap((h @ w.to(h.dtype)).float(), cfg.final_logit_softcap)
    g = sh.tp_of(cfg.vocab)
    return logits if g is None else sh.all_gather(logits, -1, g.axes)


def _positions(n: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


def encode(model: Model, cfg: ArchConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """The encoder's final states [B, S_enc, D] of frame embeddings (the
    stub front end's [B, S_enc, D], cast to the activation dtype)."""
    x = frames.to(_torch_dtype(cfg.dtype))
    x, _ = apply_stack(model, x, cfg, encoder_plan(cfg),
                       positions=_positions(x.shape[1], x.device),
                       tag="enc_g")
    return rms_norm(x, model["enc_final_norm"], cfg.norm_eps)


def decoder_inputs(model: Model, cfg: ArchConfig, batch: Dict
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """(x, positions, enc_out) of a batch (the reference's
    ``_decoder_inputs``): an encoder-decoder encodes ``batch["frames"]``;
    a VLM prepends ``batch["patches"]`` [B, P, D], cast to the activation
    dtype, to the token embeddings, and its positions run over both."""
    x = embed_tokens(model, cfg, batch["tokens"])
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(model, cfg, batch["frames"])
    elif cfg.vision_prefix_tokens:
        x = torch.cat([batch["patches"].to(x.dtype), x], 1)
    return x, _positions(x.shape[1], x.device), enc_out


@torch.no_grad()
def forward_hidden(model: Model, cfg: ArchConfig, batch: Dict) -> torch.Tensor:
    """Final hidden states [B, P + S, D] of a batch (tokens [B, S], and
    frames or P patches where the config takes them), no cache."""
    x, positions, enc_out = decoder_inputs(model, cfg, batch)
    x, _ = apply_stack(model, x, cfg, layer_plan(cfg), positions=positions,
                       enc_out=enc_out)
    return x


# ---------------------------------------------------------------------------
# training: loss and forward
# ---------------------------------------------------------------------------


def xent_loss(model: Model, cfg: ArchConfig, h: torch.Tensor,
              labels: torch.Tensor, n_chunks: int = 8) -> torch.Tensor:
    """Mean next-token cross-entropy of final states h [B, S, D] against
    labels [B, S] (the reference's chunked ``xent_loss``): ``n_chunks``
    reduced until it divides S, each chunk's float32 [B, S / n_chunks, V]
    logits made, reduced to a sum and dropped -- under grad each chunk is
    checkpointed, so its backward recomputes the logits instead of
    keeping them -- then the sum of the chunks over B * S."""
    B, S, _ = h.shape
    n_chunks = min(n_chunks, S)
    while S % n_chunks:
        n_chunks -= 1
    width = S // n_chunks

    def chunk_loss(hh: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
        logits = logits_fn(model, cfg, hh)                 # [B, s, V] f32
        lse = torch.logsumexp(logits, -1)
        picked = torch.gather(logits, -1, ll[..., None].long())[..., 0]
        return (lse - picked).sum()

    chunk = _remat(chunk_loss, "full")
    total = torch.stack([chunk(h[:, c:c + width], labels[:, c:c + width])
                         for c in range(0, S, width)]).sum()
    return total / (B * S)


def forward_train(model: Model, cfg: ArchConfig,
                  batch: Dict) -> torch.Tensor:
    """Mean next-token loss of one (micro)batch: ``tokens`` / ``labels``
    [B, S] (with ``frames`` or ``patches`` where the config takes them);
    a VLM's loss covers only the text after its patch prefix.  ``model``
    is a ``Model`` or its ``compute_view``."""
    x, positions, enc_out = decoder_inputs(model, cfg, batch)
    x, _ = apply_stack(model, x, cfg, layer_plan(cfg), positions=positions,
                       enc_out=enc_out)
    if cfg.vision_prefix_tokens:
        x = x[:, cfg.vision_prefix_tokens:]
    return xent_loss(model, cfg, x, batch["labels"])
