"""MoLe for LM-family architectures on PyTorch: the discrete (token) mode.

Ported from ``repro.core.lm``.  The provider ships ``pi(tokens)`` for a
secret vocabulary permutation ``pi``; the developer's Aug-Embedding is the
table with ``pi`` pre-composed (``AugE[pi(v)] == E[v]``) and the fused LM
head emits logits in morphed vocab order.  Both fusions are gathers and stay
gathers (numpy on the host: the registry stages the fused tables on the
device one slot at a time).

Secrets are numpy-RNG-derived exactly as in the reference
(``np.random.default_rng(seed).permutation(vocab)``), and
``LMSessionRegistry.restore_state`` accepts the reference registry's
``snapshot_state``, so both packages serve byte-equal secrets.

The continuous (embedding / frontend) mode — ``EmbeddingMorpher`` and
``fuse_aug_projection``, the registry's ``d_in``/``w_in`` lane — is not
ported yet: asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .protocol import SlotRegistry
from .redact import describe_array

__all__ = [
    "TokenMorpher",
    "LMSession",
    "LMSessionRegistry",
    "fuse_aug_embedding",
    "fuse_aug_head",
]

_FEATURES_LATER = (
    "the continuous (features) LM lane — EmbeddingMorpher, "
    "fuse_aug_projection, d_in/w_in — is not ported yet (a later slice)"
)


@dataclasses.dataclass
class TokenMorpher:
    """Provider-side secret vocabulary permutation (discrete MoLe)."""

    perm: np.ndarray       # pi: original id -> morphed id
    inv_perm: np.ndarray   # pi^{-1}

    @classmethod
    def create(cls, seed: int, vocab: int) -> "TokenMorpher":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(vocab)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(vocab)
        return cls(perm=perm, inv_perm=inv)

    @property
    def vocab(self) -> int:
        return self.perm.shape[0]

    def __repr__(self) -> str:
        # Redacted: the permutation IS the tenant's key.
        return (
            f"TokenMorpher(perm={describe_array(self.perm)}, "
            f"inv_perm={describe_array(self.inv_perm)})"
        )

    def morph_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Apply pi elementwise (tokens and labels alike)."""
        return torch.from_numpy(self.perm).to(tokens.device)[tokens]

    def unmorph_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(self.inv_perm).to(tokens.device)[tokens]


def fuse_aug_embedding(embedding: np.ndarray,
                       morpher: TokenMorpher) -> np.ndarray:
    """Developer-facing Aug-Embedding table: row ``pi(v)`` holds ``E[v]``.

    ``AugE[morph(tokens)] == E[tokens]`` — exact equivalence, the discrete
    analogue of paper eq. (5).
    """
    return np.asarray(embedding)[morpher.inv_perm]


def fuse_aug_head(head: np.ndarray, morpher: TokenMorpher) -> np.ndarray:
    """LM-head fused so logits come out in *morphed* vocab order.

    ``head``: (d_model, V); column ``pi(v)`` of the result is column ``v``.
    """
    return np.take(np.asarray(head), morpher.inv_perm, axis=1)


@dataclasses.dataclass
class LMSession:
    """One LM tenant's provider/developer pair for the delivery engine.

    The provider holds the secret ``morpher``; the developer-facing
    artifacts are the fused ``aug_embedding`` and ``aug_head``, both fused
    **lazily** (cached on first access): token morphing alone never touches
    the (V, d_model) tables, and at production vocab sizes each fused copy
    is the dominant host cost.
    """

    morpher: TokenMorpher
    embedding: np.ndarray                          # (V, d_model) dev table
    head: np.ndarray | None = None                 # (d_model, V) untied head
    _aug_embedding: np.ndarray | None = dataclasses.field(
        default=None, repr=False
    )
    _aug_head: np.ndarray | None = dataclasses.field(default=None, repr=False)

    @property
    def aug_embedding(self) -> np.ndarray:
        """(V, d_model) fused AugE table (``AugE[pi(v)] == E[v]``)."""
        if self._aug_embedding is None:
            self._aug_embedding = fuse_aug_embedding(
                self.embedding, self.morpher
            )
        return self._aug_embedding

    @property
    def aug_head(self) -> np.ndarray:
        """(d_model, V) fused LM head emitting *morphed-order* logits.

        Untied checkpoints fuse their ``head`` through the vocab morph; tied
        ones reuse the AugE table transposed.
        """
        if self._aug_head is None:
            if self.head is not None:
                self._aug_head = fuse_aug_head(self.head, self.morpher)
            else:
                self._aug_head = np.ascontiguousarray(self.aug_embedding.T)
        return self._aug_head

    def morph_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.morpher.morph_tokens(tokens)

    def unmorph_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.morpher.unmorph_tokens(tokens)

    def deliver_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Per-request reference path: morph then Aug-embed (== E[tokens])."""
        table = torch.from_numpy(self.aug_embedding).to(tokens.device)
        return table[self.morph_tokens(tokens)]

    def __repr__(self) -> str:
        # Redacted: every array here is a tenant secret or fused from one.
        return (
            f"LMSession(morpher={self.morpher!r}, "
            f"embedding={describe_array(self.embedding)}, "
            f"head={describe_array(self.head)})"
        )


class LMSessionRegistry(SlotRegistry):
    """Provider-side registry of per-tenant LM-MoLe sessions (token mode).

    All tenants share one ``vocab`` / ``d_model``, which makes their secrets
    stackable into dense slot-indexed arrays the engine and the decode lane
    index per group or row:

      * ``slot_perm``           (V,) int32        per-slot token morph
      * ``slot_aug_embedding``  (V, d_model)      per-slot AugE table
      * ``slot_aug_head``       (d_model, V)      per-slot fused LM head

    Slot churn (LRU eviction, ``updates_since``) is inherited from
    :class:`SlotRegistry`, the reference's code.
    """

    def __init__(
        self,
        vocab: int,
        d_model: int,
        *,
        d_in: int | None = None,
        d_out: int | None = None,
        kappa: int = 1,
        core_mode: str = "orthogonal",
        capacity: int | None = None,
    ):
        super().__init__(capacity)
        if d_in is not None or d_out is not None:
            raise NotImplementedError(_FEATURES_LATER)
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.d_in = None
        self.d_out = None
        self.kappa = kappa
        self.core_mode = core_mode

    def register(
        self,
        tenant_id: str,
        embedding: np.ndarray,
        w_in: np.ndarray | None = None,
        seed: int | None = None,
        weight: float = 1.0,
        head: np.ndarray | None = None,
    ) -> LMSession:
        """Create an LM tenant with a fresh vocab permutation.

        ``embedding`` is the developer's (V, d_model) table; ``head`` the
        (d_model, V) output projection of an *untied* checkpoint (omitted:
        the tenant decodes with the tied head ``AugE.T``).  ``weight`` is
        the tenant's weighted-fair-queueing share.
        """
        if w_in is not None:
            raise NotImplementedError(_FEATURES_LATER)
        embedding = np.asarray(embedding, np.float32)
        if embedding.shape != (self.vocab, self.d_model):
            raise ValueError(
                f"expected embedding ({self.vocab}, {self.d_model}), "
                f"got {embedding.shape}"
            )
        if head is not None:
            head = np.asarray(head, np.float32)
            if head.shape != (self.d_model, self.vocab):
                raise ValueError(
                    f"expected head ({self.d_model}, {self.vocab}), "
                    f"got {head.shape}"
                )
        seed = self._resolve_seed(seed)
        sess = LMSession(
            morpher=TokenMorpher.create(seed, self.vocab),
            embedding=embedding, head=head,
        )
        self._adopt(tenant_id, sess)
        if weight != 1.0:
            self.set_weight(tenant_id, weight)
        return sess

    def session(self, tenant_id: str) -> LMSession:
        return self._sessions[tenant_id]

    # -- crash-recovery serialization ----------------------------------------
    def _config_state(self) -> dict:
        return {
            "vocab": self.vocab,
            "d_model": self.d_model,
            "d_in": self.d_in,
            "d_out": self.d_out,
            "kappa": self.kappa,
            "core_mode": self.core_mode,
        }

    def _session_state(self, sess: LMSession) -> tuple[dict, dict[str, np.ndarray]]:
        arrays: dict[str, np.ndarray] = {
            "perm": np.asarray(sess.morpher.perm),
            "embedding": np.asarray(sess.embedding),
        }
        if sess.head is not None:
            arrays["head"] = np.asarray(sess.head)
        # analysis: declassified(per-session crash state: packed into the registry snapshot, never serialized elsewhere)
        return {"has_head": sess.head is not None}, arrays

    def _session_from_state(
        self, meta: dict, arrays: dict[str, np.ndarray]
    ) -> LMSession:
        if "embed_core" in arrays:
            raise NotImplementedError(_FEATURES_LATER)
        perm = np.asarray(arrays["perm"])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        # The fused aug_embedding/aug_head copies are derived, not secrets:
        # left to recompute lazily on first access.
        return LMSession(
            morpher=TokenMorpher(perm=perm, inv_perm=inv),
            embedding=np.asarray(arrays["embedding"], np.float32),
            head=(
                np.asarray(arrays["head"], np.float32)
                if meta["has_head"] else None
            ),
        )

    # -- per-slot secret views consumed by the engine and the decode lane ---
    def slot_perm(self, slot: int) -> np.ndarray:
        """(V,) int32 token morph in ``slot``; a free slot reads back as the
        identity permutation (still valid gather indices)."""
        t = self._slot_tenant[slot]
        if t is None:
            return np.arange(self.vocab, dtype=np.int32)
        return self._sessions[t].morpher.perm.astype(np.int32)

    def slot_aug_embedding(self, slot: int) -> np.ndarray:
        """(V, d_model) AugE table in ``slot`` (zeros when free)."""
        t = self._slot_tenant[slot]
        if t is None:
            return np.zeros((self.vocab, self.d_model), np.float32)
        return self._sessions[t].aug_embedding

    def slot_aug_head(self, slot: int) -> np.ndarray:
        """(d_model, V) fused LM head in ``slot`` (zeros when free)."""
        t = self._slot_tenant[slot]
        if t is None:
            return np.zeros((self.d_model, self.vocab), np.float32)
        return self._sessions[t].aug_head

    def stacked_perms(self) -> np.ndarray:
        return np.stack([self.slot_perm(s) for s in range(self.capacity)])

    def stacked_aug_embeddings(self) -> np.ndarray:
        return np.stack(
            [self.slot_aug_embedding(s) for s in range(self.capacity)]
        )

    def stacked_aug_heads(self) -> np.ndarray:
        return np.stack([self.slot_aug_head(s) for s in range(self.capacity)])
