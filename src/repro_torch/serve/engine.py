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
    logical axes, ``Model.axes``); a leaf the mesh splits is all-gathered
    whole where the step reads it, in its own dtype (bf16 matrices), and
    dropped after its layer (``gathered_view``), and a leaf it does not
    split is read in place, with no copy -- on a (1, 1) mesh nothing is
    copied;
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
Every rank of a model group computes every head of its batch block: the
"model" axis splits the cache and the weights' memory, not the compute
(tensor-parallel compute is ROADMAP item 12).
"""
from __future__ import annotations

import contextlib
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
    all-gathers (dim, process group, ranks) that make it whole, minor axis
    first -- an axis of one rank splits nothing.  Read from the leaves'
    placements once a sharded model and kept on it (a DTensor's
    placements and ``to_local`` cost tens of microseconds a read, and a
    step reads every leaf)."""
    from ..train import step as T
    plan = getattr(model, "_serve_gather_plan", None)
    params = list(model.parameters())
    if plan is not None and plan.keys() == {id(p) for p in params}:
        return plan
    plan = {}
    for p in params:
        mesh = p.device_mesh
        sizes = sh.mesh_shape(mesh)
        plan[id(p)] = (p.to_local(), tuple(
            (d, mesh.get_group(a), sizes[a])
            for d, entry in enumerate(T._spec_of(p))
            for a in reversed(sh.entry_axes(entry)) if sizes[a] > 1))
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


def gathered_view(model: M.Model, gather: Callable) -> M.ParamView:
    """A ``ParamView`` of ``model`` whose leaves are ``gather(leaf)``, made
    where a step reads them: a layer's once for the layer, the top-level
    leaves (embed, lm_head) at each read."""
    stack = lambda groups: [_Units(units, gather) for units in groups]
    return M.ParamView(model.cfg, _Gathered(model.top, gather, False),
                       stack(model.groups), stack(model.enc_groups))


def _params(model):
    """``model``, or for a model sharded by ``shard_model`` (which must be
    served under its mesh's ``mesh_context``) its ``gathered_view``: each
    leaf's block all-gathered whole (``_gather_plan``), or the block
    itself where nothing splits it."""
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

    def whole(leaf: torch.Tensor) -> torch.Tensor:
        local, gathers = plan[id(leaf)]
        for d, group, n in gathers:
            local = T._gather(local, d, group, n)
        return local
    return gathered_view(model, whole)


def _step_facts(cache: List, position: int):
    """Under an active mesh, the context recording the whole sizes the
    rank's cache blocks were cut from (``serve.cache.whole_sizes`` of the
    spec its ``Blocks`` keep) and the step's first ``position``; outside
    one, nothing."""
    if sh.current_mesh() is None:
        return contextlib.nullcontext()
    spec = getattr(cache, "spec", None)
    if spec is None:
        raise ValueError("a sharded step serves a cache made by "
                         "serve.cache.zeros(..., mesh=mesh)")
    return sh.step_facts({**C.whole_sizes(spec), "position": position})


@torch.no_grad()
def prefill(model: M.Model, cfg: ArchConfig, batch: Dict, cache: List
            ) -> Tuple[torch.Tensor, List]:
    """Run the prompt ``batch["tokens"]`` [B, S] (with ``frames`` [B,
    S_enc, D] or ``patches`` [B, P, D] for the stub front ends) through
    the stack, filling the cache.  Returns (last-position logits [B, V]
    float32, cache)."""
    model = _params(model)
    with _step_facts(cache, 0):
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
    x = M.embed_tokens(model, cfg, tokens)
    positions = M._positions(1, x.device, start=int(position))
    with _step_facts(cache, int(position)):
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
