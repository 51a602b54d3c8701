"""Deterministic, seekable synthetic token source.

Copied from ``repro.data.pipeline`` (``DataConfig`` and ``SyntheticLM``,
numpy only), so both packages draw the same prompts from the same seed.
Batch ``i`` is a pure function of ``(seed, i)``.  Synthetic text: a mixture
of Zipf-distributed unigrams and a deterministic "grammar" (next token
depends on the current token).  The reference's ``ProviderStage`` and
sharded loader arrive with the training slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    grammar_strength: float = 0.7   # P(next token = g(cur)) vs unigram draw


class SyntheticLM:
    """Stateless synthetic token source."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed unigram distribution (Zipf) + deterministic successor map
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.unigram = probs / probs.sum()
        self.successor = rng.permutation(cfg.vocab)

    def batch(self, index: int) -> dict:
        """Batch ``index`` -> {tokens, targets} (B, S) int32, pure function."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, 1, index))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.choice(cfg.vocab, size=B, p=self.unigram)
        follow = rng.random((B, S)) < cfg.grammar_strength
        draws = rng.choice(cfg.vocab, size=(B, S), p=self.unigram)
        for t in range(S):
            nxt = self.successor[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, draws[:, t])
        return {
            "tokens": toks[:, :S].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }
