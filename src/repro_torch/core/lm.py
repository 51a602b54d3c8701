"""MoLe for LM-family architectures on PyTorch.

Ported from ``repro.core.lm``.  Two delivery modes, both first-layer-only:

**Discrete (token) morphing.**  The provider ships ``pi(tokens)`` for a
secret vocabulary permutation ``pi``; the developer's Aug-Embedding is the
table with ``pi`` pre-composed (``AugE[pi(v)] == E[v]``) and the fused LM
head emits logits in morphed vocab order.  Both fusions are gathers and stay
gathers (numpy on the host: the registry stages the fused tables on the
device one slot at a time).

**Continuous (embedding / frontend) morphing.**  For per-position features
(VLM patch embeddings, audio frames) the paper's scheme applies verbatim
with ``m^2 -> 1``, ``alpha -> d_in``: a block-diagonal ``M`` over the
feature dim, and ``AugProj = M^{-1} W_in`` (optionally ``P_out``-permuted)
fused into the input projection.

Secrets are numpy-RNG-derived exactly as in the reference
(``np.random.default_rng(seed).permutation(vocab)``; the continuous core
from the domain-separated seed ``SeedSequence([seed, 1])``), and
``LMSessionRegistry.restore_state`` accepts the reference registry's
``snapshot_state``, so both packages serve byte-equal secrets.  The fused
projection is computed in torch fp32 (the reference sums in jnp fp32), so it
agrees with the reference's to fp32 rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .morphing import MorphCore, make_core, morph
from .protocol import SlotRegistry, _resident
from .redact import describe_array

__all__ = [
    "TokenMorpher",
    "EmbeddingMorpher",
    "LMSession",
    "LMSessionRegistry",
    "fuse_aug_embedding",
    "fuse_aug_head",
    "fuse_aug_projection",
]


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


def fuse_aug_embedding(embedding, morpher: TokenMorpher):
    """Developer-facing Aug-Embedding table: row ``pi(v)`` holds ``E[v]``.

    ``AugE[morph(tokens)] == E[tokens]`` — exact equivalence, the discrete
    analogue of paper eq. (5).  ``embedding``: a (V, d) numpy array or
    tensor; the result is of the same kind (a numpy table is gathered by
    torch's ``index_select``, on every core: a copy, as numpy's would be).
    """
    if isinstance(embedding, torch.Tensor):
        return embedding[morpher.inv_perm]
    embedding = np.asarray(embedding)
    if not embedding.flags.writeable:   # e.g. restored from a snapshot
        return embedding[morpher.inv_perm]
    return torch.from_numpy(embedding).index_select(
        0, torch.from_numpy(morpher.inv_perm)).numpy()


def fuse_aug_head(head, morpher: TokenMorpher):
    """LM-head fused so logits come out in *morphed* vocab order.

    ``head``: (d_model, V) numpy array or tensor; column ``pi(v)`` of the
    result is column ``v``.
    """
    if isinstance(head, torch.Tensor):
        return head[:, morpher.inv_perm]
    head = np.asarray(head)
    if not head.flags.writeable:        # e.g. restored from a snapshot
        return np.take(head, morpher.inv_perm, axis=1)
    # index_select keeps the result C-contiguous (head[:, idx] would not)
    return torch.from_numpy(head).index_select(
        1, torch.from_numpy(morpher.inv_perm)).numpy()


@dataclasses.dataclass
class EmbeddingMorpher:
    """Provider-side continuous morphing over a per-position feature dim."""

    core: MorphCore
    out_perm: np.ndarray | None  # secret permutation of d_model outputs
    _core_on: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )                            # device -> core tensor

    @classmethod
    def create(
        cls,
        seed: int,
        d_in: int,
        kappa: int,
        d_out: int | None = None,
        core_mode: str = "orthogonal",
    ) -> "EmbeddingMorpher":
        rng = np.random.default_rng(seed)
        core = make_core(rng, d_in, kappa, mode=core_mode)
        perm = rng.permutation(d_out) if d_out is not None else None
        return cls(core=core, out_perm=perm)

    def morph_features(self, x: torch.Tensor) -> torch.Tensor:
        """(..., d_in) -> morphed (..., d_in) on ``x``'s device; eq. 2 with
        m^2 = 1, alpha = d_in (the core is copied to a device once)."""
        core = _resident(self._core_on, self.core.matrix, x.device)
        return morph(x, core, self.core.kappa)

    def __repr__(self) -> str:
        # Redacted: MorphCore repr is itself redacted; out_perm is secret.
        return (
            f"EmbeddingMorpher(core={self.core!r}, "
            f"out_perm={describe_array(self.out_perm)})"
        )


def fuse_aug_projection(w_in: torch.Tensor,
                        morpher: EmbeddingMorpher) -> torch.Tensor:
    """``AugProj = M^{-1} @ W_in @ P_out`` — the LM Aug-Conv analogue.

    ``w_in``: (d_in, d_out) tensor; the product runs in ``w_in``'s dtype on
    its device.  For morphed features ``t``:
    ``t @ AugProj == (x @ W_in)[..., perm]`` up to rounding.
    """
    q, kappa = morpher.core.q, morpher.core.kappa
    d_in, d_out = w_in.shape
    inv = torch.as_tensor(morpher.core.inverse, dtype=w_in.dtype,
                          device=w_in.device)
    fused = torch.matmul(inv, w_in.reshape(kappa, q, d_out)).reshape(d_in, d_out)
    if morpher.out_perm is not None:
        fused = fused[:, morpher.out_perm]
    return fused


@dataclasses.dataclass
class LMSession:
    """One LM tenant's provider/developer pair for the delivery engine.

    The provider holds the secrets (``morpher`` and, when the registry has a
    continuous lane, ``embed_morpher``); the developer-facing artifacts are
    the fused ``aug_embedding`` and ``aug_head`` and, continuously, the fused
    ``aug_projection`` (``morph(x) @ AugProj == x @ W_in``).  The first two
    are fused **lazily** (cached on first access): token morphing alone
    never touches the (V, d_model) tables, and at production vocab sizes
    each fused copy is the dominant host cost.
    """

    morpher: TokenMorpher
    embedding: np.ndarray                          # (V, d_model) dev table
    embed_morpher: EmbeddingMorpher | None = None
    aug_projection: np.ndarray | None = None       # (d_in, d_out)
    head: np.ndarray | None = None                 # (d_model, V) untied head
    _aug_embedding: np.ndarray | None = dataclasses.field(
        default=None, repr=False
    )
    _aug_head: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _proj_on: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )                                              # device -> AugProj tensor

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
        ones reuse the AugE table transposed, as a view (no second (V, d)
        array on the host: the device plan copies it slot by slot).
        """
        if self._aug_head is None:
            if self.head is not None:
                self._aug_head = fuse_aug_head(self.head, self.morpher)
            else:
                self._aug_head = self.aug_embedding.T
        return self._aug_head

    def morph_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.morpher.morph_tokens(tokens)

    def unmorph_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.morpher.unmorph_tokens(tokens)

    def deliver_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Per-request reference path: morph then Aug-embed (== E[tokens])."""
        table = torch.from_numpy(self.aug_embedding).to(tokens.device)
        return table[self.morph_tokens(tokens)]

    def deliver_features(self, x: torch.Tensor) -> torch.Tensor:
        """Per-request continuous path on ``x``'s device: morph the
        features, then one ``torch.matmul`` with the fused projection."""
        if self.embed_morpher is None:
            raise ValueError("session has no continuous (embedding) lane")
        proj = _resident(self._proj_on, self.aug_projection, x.device)
        return torch.matmul(self.embed_morpher.morph_features(x), proj)

    def __repr__(self) -> str:
        # Redacted: every array here is a tenant secret or fused from one.
        return (
            f"LMSession(morpher={self.morpher!r}, "
            f"embedding={describe_array(self.embedding)}, "
            f"embed_morpher={self.embed_morpher!r}, "
            f"aug_projection={describe_array(self.aug_projection)}, "
            f"head={describe_array(self.head)})"
        )


class LMSessionRegistry(SlotRegistry):
    """Provider-side registry of per-tenant LM-MoLe sessions.

    All tenants share one ``vocab`` / ``d_model`` (and, when the continuous
    lane is enabled, one ``d_in`` / ``d_out`` / ``kappa``), which makes their
    secrets stackable into dense slot-indexed arrays the engine and the
    decode lane index per group or row:

      * ``slot_perm``           (V,) int32        per-slot token morph
      * ``slot_aug_embedding``  (V, d_model)      per-slot AugE table
      * ``slot_aug_head``       (d_model, V)      per-slot fused LM head
      * ``slot_embed_core``     (q, q)            continuous morph core
      * ``slot_aug_projection`` (d_in, d_out)     fused input projection

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
        if (d_in is None) != (d_out is None):
            raise ValueError("d_in and d_out must be given together")
        if d_in is not None and d_in % kappa:
            raise ValueError(f"kappa={kappa} must divide d_in={d_in}")
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.d_in = d_in
        self.d_out = d_out
        self.kappa = kappa
        self.core_mode = core_mode

    @property
    def has_embed_lane(self) -> bool:
        """Whether tenants also carry continuous (embedding-MoLe) secrets."""
        return self.d_in is not None

    def register(
        self,
        tenant_id: str,
        embedding: np.ndarray,
        w_in: np.ndarray | None = None,
        seed: int | None = None,
        weight: float = 1.0,
        head: np.ndarray | None = None,
    ) -> LMSession:
        """Create an LM tenant: a fresh vocab permutation and, with a
        continuous lane, a fresh morph core and its fused projection.

        ``embedding`` is the developer's (V, d_model) table; ``w_in`` its
        (d_in, d_out) continuous-lane analogue; ``head`` the (d_model, V)
        output projection of an *untied* checkpoint (omitted: the tenant
        decodes with the tied head ``AugE.T``).  ``weight`` is the tenant's
        weighted-fair-queueing share.
        """
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
        morpher = TokenMorpher.create(seed, self.vocab)
        embed_morpher = aug_projection = None
        if self.has_embed_lane:
            if w_in is None:
                raise ValueError(
                    "registry has a continuous lane; pass w_in (d_in, d_out)"
                )
            w_in = np.asarray(w_in, np.float32)
            if w_in.shape != (self.d_in, self.d_out):
                raise ValueError(
                    f"expected w_in ({self.d_in}, {self.d_out}), got {w_in.shape}"
                )
            # Serving mode (no output permutation): delivered features equal
            # the plain forward.  Domain-separated seed: recovering the vocab
            # permutation (a substitution cipher) must not let an attacker
            # regenerate the continuous lane's core from the same rng stream.
            embed_seed = int(
                np.random.SeedSequence([seed, 1]).generate_state(1)[0]
            )
            embed_morpher = EmbeddingMorpher.create(
                embed_seed, self.d_in, self.kappa, d_out=None,
                core_mode=self.core_mode,
            )
            aug_projection = fuse_aug_projection(
                torch.from_numpy(np.require(w_in, requirements=("C", "W"))),
                embed_morpher,
            ).numpy()
        elif w_in is not None:
            raise ValueError("w_in given but the registry has no continuous lane")
        sess = LMSession(
            morpher=morpher, embedding=embedding,
            embed_morpher=embed_morpher, aug_projection=aug_projection,
            head=head,
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
        if sess.embed_morpher is not None:
            arrays["embed_core"] = np.asarray(sess.embed_morpher.core.matrix)
            arrays["embed_core_inv"] = np.asarray(sess.embed_morpher.core.inverse)
            arrays["aug_projection"] = np.asarray(sess.aug_projection)
            if sess.embed_morpher.out_perm is not None:
                arrays["embed_out_perm"] = np.asarray(sess.embed_morpher.out_perm)
        # analysis: declassified(per-session crash state: packed into the registry snapshot, never serialized elsewhere)
        return {"has_head": sess.head is not None}, arrays

    def _session_from_state(
        self, meta: dict, arrays: dict[str, np.ndarray]
    ) -> LMSession:
        perm = np.asarray(arrays["perm"])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        embed_morpher = aug_projection = None
        if "embed_core" in arrays:
            embed_morpher = EmbeddingMorpher(
                core=MorphCore(
                    matrix=np.asarray(arrays["embed_core"], np.float32),
                    inverse=np.asarray(arrays["embed_core_inv"], np.float32),
                    kappa=self.kappa,
                    mode=self.core_mode,
                ),
                out_perm=arrays.get("embed_out_perm"),
            )
            aug_projection = np.asarray(arrays["aug_projection"], np.float32)
        # The fused aug_embedding/aug_head copies are derived, not secrets:
        # left to recompute lazily on first access.
        return LMSession(
            morpher=TokenMorpher(perm=perm, inv_perm=inv),
            embedding=np.asarray(arrays["embedding"], np.float32),
            embed_morpher=embed_morpher,
            aug_projection=aug_projection,
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

    def slot_head_tied(self, slot: int) -> bool:
        """Whether ``slot``'s Aug-head is its AugE table transposed: its
        tenant registered no ``head`` (tied embeddings), or the slot is
        free (both zeros)."""
        t = self._slot_tenant[slot]
        return t is None or self._sessions[t].head is None

    def slot_aug_head(self, slot: int) -> np.ndarray:
        """(d_model, V) fused LM head in ``slot`` (zeros when free)."""
        t = self._slot_tenant[slot]
        if t is None:
            return np.zeros((self.d_model, self.vocab), np.float32)
        return self._sessions[t].aug_head

    @property
    def _core_q(self) -> int:
        return self.d_in // self.kappa

    def slot_embed_core(self, slot: int) -> np.ndarray:
        """(q, q) continuous morph core in ``slot`` (zeros when free)."""
        t = self._slot_tenant[slot]
        if t is None:
            return np.zeros((self._core_q, self._core_q), np.float32)
        return np.asarray(self._sessions[t].embed_morpher.core.matrix)

    def slot_aug_projection(self, slot: int) -> np.ndarray:
        """(d_in, d_out) fused projection in ``slot`` (zeros when free)."""
        t = self._slot_tenant[slot]
        if t is None:
            return np.zeros((self.d_in, self.d_out), np.float32)
        return self._sessions[t].aug_projection

    def stacked_perms(self) -> np.ndarray:
        return np.stack([self.slot_perm(s) for s in range(self.capacity)])

    def stacked_aug_embeddings(self) -> np.ndarray:
        return np.stack(
            [self.slot_aug_embedding(s) for s in range(self.capacity)]
        )

    def stacked_aug_heads(self) -> np.ndarray:
        return np.stack([self.slot_aug_head(s) for s in range(self.capacity)])

    def stacked_embed_cores(self) -> np.ndarray:
        return np.stack(
            [self.slot_embed_core(s) for s in range(self.capacity)]
        )

    def stacked_aug_projections(self) -> np.ndarray:
        return np.stack(
            [self.slot_aug_projection(s) for s in range(self.capacity)]
        )
