"""Deterministic, seekable synthetic data pipeline with a MoLe provider
stage.

Copied from ``repro.data.pipeline``, so both packages draw the same
batches from the same seed:

  * **stateless indexing** — batch ``i`` is a pure function of
    ``(seed, i)``, so a restart is a seek, not a replay;
  * **frontend stub** — a frontend model's batch carries (B, n_tokens,
    d_in) fp32 drawn from ``(seed, 2, i)``: a vlm's ``patches`` (the
    stubbed vision tower's output), an audio model's ``frames`` (the
    stubbed conv frontend's);
  * **provider stage** — with MoLe on, the stream leaving the pipeline is
    morphed: tokens by the secret vocabulary permutation (labels
    included), or in embedding mode the patches or frames by the
    block-diagonal core; the trainer never sees raw data.

Synthetic text: a mixture of Zipf-distributed unigrams and a deterministic
"grammar" (next token depends on the current token), so a model can learn
it.  The reference morphs the patches and frames with ``np.einsum`` on the
host; here they go through the provider's morph kernel K4
(:func:`repro_torch.kernels.ops.morph_rows`) on the pipeline's device, the
card unless the caller names another, and stay there: the same function,
fp32 in and out.  On the CPU K4 runs its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..core.lm import EmbeddingMorpher, TokenMorpher
from ..core.protocol import _resident
from ..device import resolve_device
from ..kernels.ops import morph_rows
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
    """The data provider's morphing stage (the trust boundary).

    ``device`` is where the embedding morph runs (the card unless the
    caller names another); the token morph is a gather on the host."""

    token_morpher: TokenMorpher | None = None
    embed_morpher: EmbeddingMorpher | None = None
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.embed_morpher is not None:
            self.device = resolve_device(self.device)

    @classmethod
    def for_model(cls, cfg: ModelConfig, device=None) -> "ProviderStage":
        if not cfg.mole.enabled:
            return cls()
        if cfg.mole.mode == "token":
            return cls(token_morpher=TokenMorpher.create(cfg.mole.seed, cfg.vocab))
        if cfg.mole.mode == "embedding":
            if cfg.frontend is None:
                raise ValueError("embedding morphing needs a frontend")
            return cls(
                embed_morpher=EmbeddingMorpher.create(
                    cfg.mole.seed, d_in=cfg.frontend.d_in, kappa=cfg.mole.kappa,
                ),
                device=device,
            )
        raise ValueError(cfg.mole.mode)

    def __call__(self, batch: dict) -> dict:
        out = dict(batch)
        if self.token_morpher is not None:
            for k in ("tokens", "targets"):
                if k in out:
                    out[k] = self.token_morpher.perm[out[k]]
        if self.embed_morpher is not None:
            for k in ("patches", "frames"):
                if k in out:
                    out[k] = self._morph(out[k])
        return out

    def _morph(self, x) -> torch.Tensor:
        """(..., kappa*q) fp32 rows times blockdiag(core) through K4 on
        ``device``; the result stays there."""
        core = self.embed_morpher.core
        xt = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        mat = _resident(self.embed_morpher._core_on, core.matrix, xt.device)
        rows = xt.reshape(-1, xt.shape[-1])
        return morph_rows(rows, mat, core.kappa).reshape(xt.shape)


class Pipeline:
    """Seekable iterator: SyntheticLM -> optional frontend stub -> provider.

    ``device`` is where the provider's embedding morph runs (the card
    unless the caller names another; only embedding mode reads it)."""

    def __init__(self, dcfg: DataConfig, model_cfg: ModelConfig | None = None,
                 start_index: int = 0, device=None):
        if model_cfg is not None:
            check_supported(model_cfg)
        self.source = SyntheticLM(dcfg)
        self.model_cfg = model_cfg
        self.provider = (
            ProviderStage.for_model(model_cfg, device) if model_cfg
            else ProviderStage()
        )
        self.index = start_index

    def seek(self, index: int) -> None:
        self.index = index

    def state(self) -> dict:
        return {"index": self.index}

    def _frontend(self, batch: dict, index: int) -> dict:
        cfg = self.model_cfg
        if cfg is None or cfg.frontend is None:
            return batch
        rng = np.random.default_rng((self.source.cfg.seed, 2, index))
        batch[cfg.frontend.batch_key] = rng.standard_normal(
            (batch["tokens"].shape[0], cfg.frontend.n_tokens, cfg.frontend.d_in)
        ).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.source.batch(self.index)
        b = self._frontend(b, self.index)
        b = self.provider(b)
        self.index += 1
        return b
