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
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..models import model as M
from ..models.config import ArchConfig


@torch.no_grad()
def prefill(model: M.Model, cfg: ArchConfig, batch: Dict, cache: List
            ) -> Tuple[torch.Tensor, List]:
    """Run the prompt ``batch["tokens"]`` [B, S] (with ``frames`` [B,
    S_enc, D] or ``patches`` [B, P, D] for the stub front ends) through
    the stack, filling the cache.  Returns (last-position logits [B, V]
    float32, cache)."""
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
