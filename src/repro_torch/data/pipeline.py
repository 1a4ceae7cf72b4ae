"""Training data pipeline: synthetic corpus -> packed token batches (the
reference's ``repro.data.pipeline``, numpy only).

A deterministic Zipf-distributed synthetic corpus with injected n-gram
structure (so tiny models can actually reduce loss), packed into fixed
(batch, seq) arrays with next-token labels. Deterministic per (seed, step):
restart-safe — resuming from a checkpoint at step k reproduces batch k+1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3
    ngram_period: int = 8      # injected structure: periodic bigrams


def synthesize_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    z = rng.zipf(cfg.zipf_a, size=(cfg.batch, cfg.seq_len + 1))
    toks = (z % (cfg.vocab - 2)) + 1
    # inject learnable structure: every `period` steps, token = f(prev token)
    period = cfg.ngram_period
    idx = np.arange(1, cfg.seq_len + 1)
    mask = (idx % period) == 0
    toks[:, idx[mask]] = (toks[:, idx[mask] - 1] * 7 + 13) % (cfg.vocab - 2) + 1
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


def data_iterator(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthesize_batch(cfg, step)
        step += 1
