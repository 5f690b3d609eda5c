"""Serving entry points of the port: prefill and decode steps over the
layer-group stack (the reference's ``serve/engine.py``).

``prefill`` embeds a prompt batch (an encoder-decoder's frames through
its encoder first, a VLM's patches before its tokens), writes every
layer's KV cache (and whisper's cross cache) and returns last-position
logits; ``decode_step`` consumes one token per
sequence against the cache; ``greedy_generate`` runs prefill and then a
Python loop of decode steps (the reference's ``lax.scan``).  The cache
(``serve.cache.zeros``) is updated in place and returned.  Every
attention call goes through ``models.layers.attend``: the flash-attention
kernel on the card, the plain versions on the CPU.

**Sharded serving.**  The same entry points serve one rank's share under
``parallel.sharding.mesh_context(mesh)``:
  * the weights lie as the train step lays out its masters
    (``shard_model``: a DTensor of the rank's block of each leaf by its
    logical axes, ``Model.axes``); a leaf the model group splits for
    tensor-parallel compute (``models.model.tp_leaves``: wq / wk / wv /
    w_gate / w_up columns, wo / w_down rows, embed rows, lm_head
    columns, where the split falls on whole heads, ffn columns or vocab
    rows) is read as the rank's block along "model", all-gathered only
    along the other axes that split it ("data" for ``fsdp``); any other
    leaf the mesh splits is all-gathered whole; each where the step
    reads it, in its own dtype (bf16 matrices), and dropped after its
    layer (``gathered_view``); a leaf nothing splits is read in place,
    with no copy -- on a (1, 1) mesh nothing is copied;
  * the step runs under ``parallel.sharding.tensor_parallel`` where the
    model axis holds more than one rank: a model rank computes its share
    of the heads (the query rows where the heads do not divide, the
    reference's fallback), of the ffn columns and of the vocabulary, and
    the layers move activations between the reference's layouts with one
    named collective each (``models/layers.py``: the output projections'
    all-reduce, the fresh K/V's all-gather along the heads for the cache,
    a decode's query heads gathered for the combine; the logits
    all-gathered along the vocabulary);
  * the cache is the rank's block (``serve.cache.zeros(..., mesh=mesh)``):
    split along ``batch`` over ("pod", "data") and along ``kv_seq`` over
    "model", the attention combining the model ranks' blocks
    (``models/layers.py``); the recurrent states stay whole on the model
    ranks;
  * the batch is the rank's rows (``batch_block``);
  * each step records what its blocks cannot tell (``parallel.sharding.
    step_facts``): the whole sizes the cache's blocks were cut from
    (``serve.cache.whole_sizes``: the global batch, which the MoE layers'
    capacity counts below the expert-parallel threshold, and the cross
    caches' encoder length, which says whether the model axis split
    them), and the step's first position, which picks the owner of a
    decode step's slot with no device read.
MLA, the MoE's experts and the recurrent blocks still compute whole on
every rank of a model group, from leaves gathered whole.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Tuple

import torch

from ..models import model as M
from ..models.config import ArchConfig
from ..parallel import sharding as sh
from . import cache as C


def shard_model(model: M.Model, mesh) -> M.Model:
    """``model`` with each leaf replaced by a DTensor on ``mesh`` holding
    this rank's block of it by its logical axes (``train.step.
    shard_state``'s layout of the masters); no communication, and a leaf
    the mesh does not split keeps its storage."""
    M.replace_parameters(model, [
        sh.distribute(p.detach(), sh.logical_spec(model.axes[name], p.shape,
                                                  mesh), mesh)
        for name, p in model.named_parameters()])
    return model


def _gather_plan(model: M.Model) -> Dict[int, Tuple]:
    """Per DTensor leaf of ``model`` (by ``id``): its local block and the
    all-gathers (dim, mesh axis, process group, ranks) that make the
    leaf the step reads, minor axis first: whole, or for a leaf of
    ``models.model.tp_leaves`` the rank's block along the model group's
    axes -- an axis of one rank splits nothing.  Read from the leaves'
    placements once a sharded model and kept on it (a DTensor's
    placements and ``to_local`` cost tens of microseconds a read, and a
    step reads every leaf)."""
    from ..train import step as T
    plan = getattr(model, "_serve_gather_plan", None)
    params = list(model.parameters())
    if plan is not None and plan.keys() == {id(p) for p in params}:
        return plan
    mesh = params[0].device_mesh
    sizes, tp_axes = sh.mesh_shape(mesh), sh.tp_axes(mesh)
    split = M.tp_leaves(model.cfg, math.prod(sizes[a] for a in tp_axes)) \
        if tp_axes else set()
    plan = {}
    for name, p in model.named_parameters():
        spec = T._spec_of(p)
        keep = tp_axes if name in split else ()
        if keep and not set(keep) <= {a for e in spec
                                      for a in sh.entry_axes(e)}:
            raise ValueError(f"{name}: {spec} does not split it along "
                             f"{keep} for tensor-parallel serving")
        plan[id(p)] = (p.to_local(), tuple(
            (d, a, mesh.get_group(a), sizes[a])
            for d, entry in enumerate(spec)
            for a in reversed(sh.entry_axes(entry))
            if sizes[a] > 1 and a not in keep))
    model._serve_gather_plan = plan
    return plan


def batch_block(batch: Dict, mesh) -> Dict:
    """This rank's rows of every entry of a global ``batch`` (tokens,
    frames, patches) by the ``batch`` rule on ``mesh``."""
    b = next(iter(batch.values())).shape[0]
    spec = sh.logical_spec(("batch",), (b,), mesh)
    rows = sh.block(spec, (b,), sh.mesh_shape(mesh),
                    sh.coordinate(mesh))[0]
    return {k: v[rows] for k, v in batch.items()}


class _Gathered:
    """One block's leaves by name, each made whole by ``gather`` where it
    is read; kept for the block's call with ``keep``."""

    def __init__(self, blk, gather: Callable, keep: bool):
        self.blk, self.gather, self.keep = blk, gather, keep
        self.got: Dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self.got.get(name)
        if t is None:
            t = self.gather(getattr(self.blk, name))
            if self.keep:
                self.got[name] = t
        return t


class _Units:
    """A layer group's repeats, each a fresh ``{"b{j}": _Gathered}`` when
    the stack reaches it, so a layer's gathered leaves go with it."""

    def __init__(self, units, gather: Callable):
        self.units, self.gather = units, gather

    def __iter__(self):
        for unit in self.units:
            yield {b: _Gathered(blk, self.gather, True)
                   for b, blk in unit.items()}


def gathered_view(model: M.Model, gather: Callable,
                  tensor_parallel: bool = False) -> M.ParamView:
    """A ``ParamView`` of ``model`` whose leaves are ``gather(leaf)``, made
    where a step reads them: a layer's once for the layer, the top-level
    leaves (embed, lm_head) at each read.  ``tensor_parallel``: the
    leaves of ``models.model.tp_leaves`` are the rank's blocks along the
    model group, and the engine's steps on the view run under
    ``parallel.sharding.tensor_parallel``."""
    stack = lambda groups: [_Units(units, gather) for units in groups]
    return M.ParamView(model.cfg, _Gathered(model.top, gather, False),
                       stack(model.groups), stack(model.enc_groups),
                       tensor_parallel)


def _params(model):
    """``model``, or for a model sharded by ``shard_model`` (which must be
    served under its mesh's ``mesh_context``) its ``gathered_view``: each
    leaf's block all-gathered as ``_gather_plan`` says (whole, or the
    rank's block along the model group), or the block itself where
    nothing is gathered."""
    if not isinstance(model, M.Model):
        return model
    from torch.distributed.tensor import DTensor
    from ..train import step as T
    p = next(model.parameters())
    if not isinstance(p, DTensor):
        return model
    if sh.current_mesh() != p.device_mesh:
        raise ValueError("a sharded model serves under mesh_context(its "
                         "mesh)")
    plan = _gather_plan(model)

    def read(leaf: torch.Tensor) -> torch.Tensor:
        local, gathers = plan[id(leaf)]
        for d, _, group, n in gathers:
            local = T._gather(local, d, group, n)
        return local
    return gathered_view(model, read, bool(sh.tp_axes(p.device_mesh)))


def _step(params, cache: List, position: int):
    """Under an active mesh, the contexts of a step: the whole sizes the
    rank's cache blocks were cut from (``serve.cache.whole_sizes`` of the
    spec its ``Blocks`` keep) and the step's first ``position``
    (``parallel.sharding.step_facts``), and for a tensor-parallel view
    (``gathered_view``) the model group (``parallel.sharding.
    tensor_parallel``); outside one, nothing."""
    stack = contextlib.ExitStack()
    if sh.current_mesh() is None:
        return stack
    spec = getattr(cache, "spec", None)
    if spec is None:
        raise ValueError("a sharded step serves a cache made by "
                         "serve.cache.zeros(..., mesh=mesh)")
    stack.enter_context(sh.step_facts({**C.whole_sizes(spec),
                                       "position": position}))
    if getattr(params, "tensor_parallel", False):
        stack.enter_context(sh.tensor_parallel())
    return stack


@torch.no_grad()
def prefill(model: M.Model, cfg: ArchConfig, batch: Dict, cache: List
            ) -> Tuple[torch.Tensor, List]:
    """Run the prompt ``batch["tokens"]`` [B, S] (with ``frames`` [B,
    S_enc, D] or ``patches`` [B, P, D] for the stub front ends) through
    the stack, filling the cache.  Returns (last-position logits [B, V]
    float32, cache)."""
    model = _params(model)
    with _step(model, cache, 0):
        x, positions, enc_out = M.decoder_inputs(model, cfg, batch)
        x, cache = M.apply_stack(model, x, cfg, M.layer_plan(cfg),
                                 positions=positions, caches=cache,
                                 enc_out=enc_out)
        return M.logits_fn(model, cfg, x[:, -1:])[:, 0], cache


@torch.no_grad()
def decode_step(model: M.Model, cfg: ArchConfig, tokens: torch.Tensor,
                position: int, cache: List) -> Tuple[torch.Tensor, List]:
    """One decode step: tokens [B, 1] at ``position`` (shared by the
    batch; the cache holds ``position`` tokens of history).  Returns the
    next token's logits [B, V] and the cache."""
    model = _params(model)
    with _step(model, cache, int(position)):
        x = M.embed_tokens(model, cfg, tokens)
        positions = M._positions(1, x.device, start=int(position))
        x, cache = M.apply_stack(model, x, cfg, M.layer_plan(cfg),
                                 positions=positions, caches=cache)
        return M.logits_fn(model, cfg, x)[:, 0], cache


@torch.no_grad()
def greedy_generate(model: M.Model, cfg: ArchConfig, batch: Dict,
                    cache: List, n_steps: int) -> Tuple[torch.Tensor, List]:
    """Prefill + greedy decode: returns (ids [B, n_steps] int32, cache).
    Decoding starts after the prompt and a VLM's patch prefix.  ``argmax``
    takes the first maximum, as ``jnp.argmax`` does."""
    logits, cache = prefill(model, cfg, batch, cache)
    prompt_len = batch["tokens"].shape[1] + (cfg.vision_prefix_tokens or 0)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(n_steps - 1):
        logits, cache = decode_step(model, cfg, tok[:, None], prompt_len + i,
                                    cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, 1), cache
