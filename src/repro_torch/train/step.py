"""Training step on one device (the reference's ``train/step.py``):
gradient accumulation, mixed precision, global-norm clipping, AdamW.

The model's leaves are float32 masters (``nn.Parameter``, requires grad).
A step casts every float32 leaf to ``compute_dtype`` once
(``models.model.compute_view``), before the microbatch loop, and
differentiates that copy: the bf16 gradients reach the masters through the
cast and are accumulated there in float32 (``.grad``), then averaged over
``accum``.  ``compute_dtype=None`` differentiates the masters themselves.
Peak activation memory is one microbatch's, the blocks rematerialized by
the config's ``remat_policy``.

The reference's pod compression, mesh and sharding arguments belong to
distributed training, which this module does not port.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.power import Device
from ..models import model as M
from ..models.config import ArchConfig
from ..optim import adamw


class TrainState(NamedTuple):
    model: M.Model
    opt: adamw.OptState
    step: torch.Tensor                         # int32 scalar


def init_state(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
               device: Device = None) -> TrainState:
    """Float32 trainable masters drawn from ``generator`` (a generator on
    ``device``; default: one seeded with 0) on ``device`` (default: the
    CUDA card), zero moments, step 0."""
    model = M.init_model(cfg, generator, device=device, trainable=True)
    opt = adamw.init(model.parameters())
    return TrainState(model=model, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt.count.device))


def decay_mask(model: M.Model) -> List[bool]:
    """Per leaf of ``model.parameters()``: whether AdamW decays it.  The
    reference decays a leaf with ``ndim >= 2`` on its own shapes, where a
    layer group's leaves carry the stacked ``repeats`` axis: every leaf in
    a layer is decayed, norm scales included, and only top-level 1-D
    leaves (``final_norm``, ``enc_final_norm``) are exempt."""
    return [p.ndim >= 2 or not name.startswith("top.")
            for name, p in model.named_parameters()]


def _to_device(batch: Dict, device: torch.device) -> Dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _split_microbatches(batch: Dict, accum: int) -> List[Dict]:
    """``accum`` microbatches cut along the leading axis, in order."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} "
                         f"microbatches")
    return [{k: v[i * (b // accum):(i + 1) * (b // accum)]
             for k, v in batch.items()} for i in range(accum)]


def make_grads_fn(cfg: ArchConfig, accum: int = 1,
                  compute_dtype: Optional[torch.dtype] = torch.bfloat16
                  ) -> Callable:
    """``grads_fn(model, batch) -> (loss, grads)``: the mean loss over the
    ``accum`` microbatches and each master's float32 gradient (the
    ``.grad`` tensors, in ``model.parameters()`` order), averaged over
    them.  ``batch``: tensors on the model's device, or numpy arrays."""

    def grads_fn(model: M.Model, batch: Dict
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        batch = _to_device(batch, params[0].device)
        view = M.compute_view(model, compute_dtype)
        loss = torch.zeros((), device=params[0].device)
        for mb in _split_microbatches(batch, accum):
            mb_loss = M.forward_train(view, cfg, mb)
            mb_loss.backward()
            loss = loss + mb_loss.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if accum > 1:
            inv = 1.0 / accum
            for g in grads:
                g.mul_(inv)
            loss = loss * inv
        return loss, grads

    return grads_fn


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    accum: int = 1,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16
                    ) -> Callable:
    """``step(state, batch) -> (state, metrics)``: gradients over
    ``accum`` microbatches, then AdamW in place on the masters (the
    reference's weight-decay rule, ``decay_mask``).  ``metrics``: ``loss``,
    ``grad_norm`` and ``lr``, 0-d tensors on the device (reading one
    waits for the step)."""
    grads_fn = make_grads_fn(cfg, accum, compute_dtype)

    def step(state: TrainState, batch: Dict
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, grads = grads_fn(state.model, batch)
        params = list(state.model.parameters())
        opt, metrics = adamw.apply_updates(params, grads, state.opt,
                                           opt_cfg, decay_mask(state.model))
        for p in params:
            p.grad = None
        metrics["loss"] = loss
        return TrainState(state.model, opt, state.step + 1), metrics

    return step
