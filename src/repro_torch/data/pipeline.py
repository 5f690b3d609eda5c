"""Deterministic synthetic-token pipeline (a copy of the reference's
``data/pipeline.py``: numpy only, no framework).

Every batch is a pure function of (seed, step, shape), byte-equal to the
reference's: resuming replays the exact token stream with no host state
beyond the step counter.  A host with (host_id, n_hosts) materializes only
its slice of the global batch; on one host the full batch is returned.

The "dataset" is a mixture of structured streams (repeating n-grams +
skip-patterns + noise) rather than iid-uniform tokens, so cross-entropy has
learnable structure and short training runs show a falling loss curve.
Batches are numpy arrays; ``train.step`` moves them to the model's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..models.config import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    host_id: int = 0
    n_hosts: int = 1
    # structure of the synthetic language
    ngram: int = 4
    n_patterns: int = 64
    noise: float = 0.05


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    # counter-based: independent stream per (seed, step, host)
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def _pattern_bank(cfg: DataConfig, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xBEEF]))
    return rng.integers(0, vocab, size=(cfg.n_patterns, cfg.ngram),
                        dtype=np.int32)


def synth_tokens(cfg: DataConfig, vocab: int, step: int,
                 batch: Optional[int] = None,
                 seq_len: Optional[int] = None) -> np.ndarray:
    """[local_batch, seq_len+1] int32 (shifted into tokens/labels later)."""
    b = (batch if batch is not None else cfg.batch) // cfg.n_hosts
    s = (seq_len if seq_len is not None else cfg.seq_len) + 1
    rng = _rng_for(cfg, step)
    bank = _pattern_bank(cfg, vocab)
    n_chunks = -(-s // cfg.ngram)
    pat = rng.integers(0, cfg.n_patterns, size=(b, n_chunks))
    toks = bank[pat].reshape(b, n_chunks * cfg.ngram)[:, :s]
    noise_mask = rng.random((b, s)) < cfg.noise
    noise = rng.integers(0, vocab, size=(b, s), dtype=np.int32)
    return np.where(noise_mask, noise, toks).astype(np.int32)


def make_batch(arch: ArchConfig, dcfg: DataConfig, step: int,
               batch: Optional[int] = None,
               seq_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Training batch for any assigned architecture (incl. stub frontends)."""
    b = batch if batch is not None else dcfg.batch
    s = seq_len if seq_len is not None else dcfg.seq_len
    rng = _rng_for(dcfg, step)
    if arch.is_encoder_decoder:
        dec = max(8, int(s * arch.decoder_frac))
        t = synth_tokens(dcfg, arch.vocab, step, batch=b, seq_len=dec)
        frames = rng.standard_normal(
            (b // dcfg.n_hosts, s, arch.d_model)).astype(np.float32) * 0.1
        return dict(tokens=t[:, :-1], labels=t[:, 1:], frames=frames)
    if arch.vision_prefix_tokens:
        text = s - arch.vision_prefix_tokens
        t = synth_tokens(dcfg, arch.vocab, step, batch=b, seq_len=text)
        patches = rng.standard_normal(
            (b // dcfg.n_hosts, arch.vision_prefix_tokens,
             arch.d_model)).astype(np.float32) * 0.1
        return dict(tokens=t[:, :-1], labels=t[:, 1:], patches=patches)
    t = synth_tokens(dcfg, arch.vocab, step, batch=b, seq_len=s)
    return dict(tokens=t[:, :-1], labels=t[:, 1:])


class DataIterator:
    """Stateful view over the stateless stream (checkpoint = step int)."""

    def __init__(self, arch: ArchConfig, dcfg: DataConfig, start_step: int = 0):
        self.arch = arch
        self.dcfg = dcfg
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = make_batch(self.arch, self.dcfg, self.step)
        self.step += 1
        return batch

    def state(self) -> int:
        return self.step

    @classmethod
    def restore(cls, arch: ArchConfig, dcfg: DataConfig,
                state: int) -> "DataIterator":
        return cls(arch, dcfg, start_step=state)
