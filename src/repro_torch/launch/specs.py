"""Abstract input specs for every (architecture x shape) cell (the
reference's ``launch/specs.py``).

No memory is allocated here: parameters, train states and batch inputs
are tensors on the ``meta`` device (shapes and dtypes only, the port's
counterpart of ``jax.ShapeDtypeStruct`` / ``eval_shape``), caches the
serving spec trees (``serve.cache.cache_spec``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import model as M
from ..models.config import ArchConfig
from ..serve import cache as C
from ..train.step import TrainState, init_state, state_axes

META = torch.device("meta")


def dec_len(cfg: ArchConfig, seq_len: int) -> int:
    """Decoder-side token count for a given assigned seq_len."""
    if cfg.is_encoder_decoder:
        return max(64, int(seq_len * cfg.decoder_frac))
    if cfg.vision_prefix_tokens:
        return seq_len - cfg.vision_prefix_tokens
    return seq_len


def abstract_model(cfg: ArchConfig, dtype: Optional[torch.dtype] = None
                   ) -> Tuple[M.Model, Dict]:
    """(the model on ``meta``, its logical axes by leaf name): float32
    masters, or every floating leaf in ``dtype``."""
    model = M.init_model(cfg, device="meta", trainable=True)
    if dtype is not None:
        M.replace_parameters(model, [
            torch.empty(p.shape, dtype=dtype, device=META)
            if p.is_floating_point() else p for p in model.parameters()])
    return model, model.axes


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def token_specs(cfg: ArchConfig, batch: int, seq_len: int,
                with_labels: bool) -> Dict[str, torch.Tensor]:
    """Token / stub-frontend input specs for one (micro)batch."""
    dl = dec_len(cfg, seq_len)
    out = {"tokens": _spec((batch, dl), torch.int32)}
    if with_labels:
        out["labels"] = _spec((batch, dl), torch.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = _spec((batch, seq_len, cfg.d_model), torch.bfloat16)
    if cfg.vision_prefix_tokens:
        out["patches"] = _spec((batch, cfg.vision_prefix_tokens,
                                cfg.d_model), torch.bfloat16)
    return out


def train_state_specs(cfg: ArchConfig, compress_pod: bool = False
                      ) -> Tuple[TrainState, TrainState]:
    """(abstract TrainState on ``meta``, the state's logical axes)."""
    state = init_state(cfg, device="meta", compress_pod=compress_pod)
    return state, state_axes(state.model, compress_pod)


def serve_specs(cfg: ArchConfig, batch: int, seq_len: int, kind: str):
    """(abstract params, axes, batch specs, extra, cache spec tree).

    kind == 'prefill': tokens are the full prompt, cache sized to hold it.
    kind == 'decode' : tokens [B, 1] + scalar position, cache holds seq_len.
    """
    params, axes = abstract_model(cfg, dtype=torch.bfloat16)
    dl = dec_len(cfg, seq_len)
    enc_len = seq_len if cfg.is_encoder_decoder else 0
    spec = C.cache_spec(cfg, batch, dl, enc_len=enc_len)
    extra: Dict[str, Any] = {}
    if kind == "prefill":
        batch_specs = token_specs(cfg, batch, seq_len, with_labels=False)
    else:
        # an encoder-decoder's cross cache already holds the encoder's K/V
        batch_specs = {"tokens": _spec((batch, 1), torch.int32)}
        extra = {"position": _spec((), torch.int32)}
    return params, axes, batch_specs, extra, spec
