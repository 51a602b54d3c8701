"""MoLe deployment transforms: fuse provider secrets into developer params.

Ported from ``repro.core.deploy``.  In the paper's pre-trained transfer /
serving flow the developer ships the first layer trained on public data and
the provider returns the Aug artifact.  :func:`fuse_lm_params` performs that
fusion on a parameter dict of tensors:

  - token mode: embedding rows through pi^{-1} (``AugE[pi(v)] = E[v]``); the
    untied LM head's columns likewise, so logits come out in morphed vocab
    order and morphed labels give the identical loss;
  - embedding mode: the frontend projection (``frontend_proj``; the audio
    encoder's ``enc_proj``) becomes ``M^{-1} @ W`` (column-permuted when the
    morpher has an output permutation, which requires downstream
    retraining, as the paper's rand() does).

From-scratch training needs no transform: the embedding table a developer
learns on morphed tokens *is* the Aug-Embedding.
"""
from __future__ import annotations

from typing import Any

from .lm import (
    EmbeddingMorpher, TokenMorpher, fuse_aug_embedding, fuse_aug_head,
    fuse_aug_projection,
)

__all__ = ["fuse_lm_params"]


def fuse_lm_params(
    params: dict[str, Any],
    cfg,
    token_morpher: TokenMorpher | None = None,
    embed_morpher: EmbeddingMorpher | None = None,
) -> dict[str, Any]:
    """Return a params dict whose first layer consumes *morphed* inputs.

    ``params`` is the model's nested dict of tensors (the reference's tree
    layout); ``cfg`` a :class:`~repro_torch.models.base.ModelConfig`, of
    which ``family`` and ``tie_embeddings`` are read.  Untouched entries are
    shared with ``params``, not copied.
    """
    out = dict(params)
    if cfg.family == "audio":
        inner = dict(out["dec"])
        if token_morpher is not None:
            inner["embed"] = fuse_aug_embedding(inner["embed"], token_morpher)
            if "head" in inner:
                inner["head"] = fuse_aug_head(inner["head"], token_morpher)
        out["dec"] = inner
        if embed_morpher is not None:
            out["enc_proj"] = fuse_aug_projection(out["enc_proj"], embed_morpher)
        return out

    if token_morpher is not None:
        out["embed"] = fuse_aug_embedding(out["embed"], token_morpher)
        if not cfg.tie_embeddings and "head" in out:
            out["head"] = fuse_aug_head(out["head"], token_morpher)
    if embed_morpher is not None and "frontend_proj" in out:
        out["frontend_proj"] = fuse_aug_projection(
            out["frontend_proj"], embed_morpher
        )
    return out
