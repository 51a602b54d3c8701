"""Deterministic, seekable synthetic data pipeline with a MoLe provider
stage.

Copied from ``repro.data.pipeline`` (numpy only), so both packages draw the
same batches from the same seed:

  * **stateless indexing** — batch ``i`` is a pure function of
    ``(seed, i)``, so a restart is a seek, not a replay;
  * **provider stage** — with MoLe on, the token stream leaving the
    pipeline is morphed by the secret vocabulary permutation (labels
    included); the trainer never sees raw tokens.

Synthetic text: a mixture of Zipf-distributed unigrams and a deterministic
"grammar" (next token depends on the current token), so a model can learn
it.  The reference's frontend stub and continuous (embedding) morphing
serve frontend models, which the port does not run yet: ``Pipeline``
refuses such configs (``check_supported``) and ``ProviderStage`` the
embedding mode.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..core.lm import TokenMorpher
from ..models.base import ModelConfig, check_supported

__all__ = ["DataConfig", "Pipeline", "ProviderStage", "SyntheticLM"]


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


@dataclasses.dataclass
class ProviderStage:
    """The data provider's morphing stage (the trust boundary)."""

    token_morpher: TokenMorpher | None = None

    @classmethod
    def for_model(cls, cfg: ModelConfig) -> "ProviderStage":
        if not cfg.mole.enabled:
            return cls()
        if cfg.mole.mode == "token":
            return cls(token_morpher=TokenMorpher.create(cfg.mole.seed, cfg.vocab))
        if cfg.mole.mode == "embedding":
            raise NotImplementedError(
                "embedding-mode MoLe morphs a frontend's features; frontend "
                "models are not ported yet"
            )
        raise ValueError(cfg.mole.mode)

    def __call__(self, batch: dict) -> dict:
        out = dict(batch)
        if self.token_morpher is not None:
            for k in ("tokens", "targets"):
                if k in out:
                    out[k] = self.token_morpher.perm[out[k]]
        return out


class Pipeline:
    """Seekable iterator: SyntheticLM -> provider stage."""

    def __init__(self, dcfg: DataConfig, model_cfg: ModelConfig | None = None,
                 start_index: int = 0):
        if model_cfg is not None:
            check_supported(model_cfg)
        self.source = SyntheticLM(dcfg)
        self.model_cfg = model_cfg
        self.provider = (
            ProviderStage.for_model(model_cfg) if model_cfg else ProviderStage()
        )
        self.index = start_index

    def seek(self, index: int) -> None:
        self.index = index

    def state(self) -> dict:
        return {"index": self.index}

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.provider(self.source.batch(self.index))
        self.index += 1
        return b
