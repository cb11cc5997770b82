"""Deterministic, seekable, sharded data pipeline.

Design goals (1000-node scale):
  * **Stateless addressing** — batch ``(step, dp_rank)`` is a pure function
    of ``(seed, step, dp_rank)``; no iterator state to snapshot.  Resume
    after preemption = restart at the checkpointed step.  Elastic re-shard =
    recompute rank strides; no data is lost or duplicated within a step.
  * **Deterministic synthetic corpus** — a seeded doc generator with a
    Zipf-ish length distribution and an order-1 Markov token chain, so a
    ~100M-param model shows a real (falling) loss curve without external
    data.  Swapping in a real tokenized corpus only replaces ``_doc``.
  * **Packing** — documents are packed into fixed ``seq_len`` rows with EOS
    separators and a loss mask; labels are next-token shifted.

A copy of the reference's ``data/pipeline.py`` (numpy only), batch for batch
bit-equal to it; the trainer moves each batch to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

EOS = 0
BOS = 1
_VOCAB_RESERVED = 2


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: int = 256
    n_codebooks: int = 1  # MusicGen: parallel codebook streams


class SyntheticCorpus:
    """Deterministic infinite corpus: doc ``i`` is a pure function of
    ``(seed, i)``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _doc(self, idx: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.Generator(np.random.PCG64(
            (cfg.seed * 0x9E3779B1 + idx) & 0xFFFFFFFF))
        # Zipf-ish doc length in [16, 4·mean]
        ln = int(np.clip(rng.pareto(1.5) * cfg.mean_doc_len * 0.5 + 16,
                         16, 4 * cfg.mean_doc_len))
        V = cfg.vocab_size - _VOCAB_RESERVED
        # order-1 Markov chain: next ≈ affine hash of current, + noise.
        # gives the model learnable structure (bigram statistics).
        a = int(rng.integers(1, 257)) * 2 + 1
        b = int(rng.integers(0, V))
        toks = np.empty(ln, np.int64)
        t = int(rng.integers(0, V))
        noise = rng.integers(0, V, size=ln)
        pick = rng.random(ln) < 0.15
        for j in range(ln):
            t = (a * t + b) % V
            if pick[j]:
                t = int(noise[j])
            toks[j] = t + _VOCAB_RESERVED
        return toks


class PackedLoader:
    """Packs corpus docs into (batch, seq_len) rows, sharded by dp rank.

    ``batch(step, rank, n_ranks)`` is deterministic and independent of call
    order — the pipeline 'state' is just the integer ``step``.
    """

    def __init__(self, cfg: DataConfig, corpus: Optional[SyntheticCorpus] = None):
        self.cfg = cfg
        self.corpus = corpus or SyntheticCorpus(cfg)

    def _row(self, row_idx: int) -> Dict[str, np.ndarray]:
        """One packed row; doc ids derive from the row index."""
        cfg = self.cfg
        S = cfg.seq_len
        toks = np.full(S + 1, EOS, np.int64)
        mask = np.zeros(S + 1, np.float32)
        pos = 0
        doc = row_idx * 1_000_003  # disjoint doc-id streams per row
        while pos < S + 1:
            d = self.corpus._doc(doc)
            doc += 1
            take = min(len(d), S + 1 - pos - 1)
            if take <= 0:
                break
            toks[pos] = BOS
            toks[pos + 1: pos + 1 + take] = d[:take]
            mask[pos: pos + 1 + take] = 1.0
            pos += take + 2  # BOS + doc + EOS separator
        return {"tokens": toks[:S], "labels": toks[1:],
                "loss_mask": mask[1:]}

    def batch(self, step: int, rank: int = 0, n_ranks: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % n_ranks == 0
        per = cfg.global_batch // n_ranks
        base = step * cfg.global_batch + rank * per
        rows = [self._row(base + i) for i in range(per)]
        out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        out["tokens"] = out["tokens"].astype(np.int32)
        out["labels"] = out["labels"].astype(np.int32)
        if cfg.n_codebooks > 1:  # replicate the chain per codebook stream
            for k in ("tokens", "labels"):
                out[k] = np.stack([
                    (out[k] + c * 17) % cfg.vocab_size
                    for c in range(cfg.n_codebooks)], axis=-1).astype(np.int32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
