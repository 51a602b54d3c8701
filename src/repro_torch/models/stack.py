"""Layer-stack assembly on PyTorch: schema and apply for a full model.

Ported from ``repro.models.stack`` for attention stacks (layer kinds
``attn`` / ``global`` and ``local``, the sliding-window kind, ``mla``,
and ``attn_moe`` / ``mla_moe`` with an MoE FFN, in any prefix, block
pattern and suffix; prefix layers of an MoE config take the dense FFN
width ``moe.first_dense_ff``), RecurrentGemma's hybrid stacks (``rec``,
the RG-LRU mixer, beside the attention kinds; a ``rec`` layer keeps the
dense FFN), vision-language stacks (``cross``, tanh-gated cross-attention
over the frontend's stream after ``frontend_proj``, beside the attention
kinds), Whisper's decoder (``dec``: self-attention, ungated
cross-attention over the encoder's output, FFN; the encoder's ``bidir``
layers attend without a mask, :mod:`repro_torch.models.whisper`) and
RWKV-6 stacks (``("rwkv",)``).  A
model is: token embedding -> its layers -> final norm -> LM head.  The
reference runs prefix layers, a scan over ``n_groups`` stacked copies of
the block pattern, then suffix layers; here ``params["blocks"]`` and
``caches["blocks"]`` are per-layer lists in ``cfg.layer_kinds()`` order
(prefix, pattern x n_groups, suffix) and :func:`apply_stack` loops over
them, each block dispatched on its kind.
Training reads :func:`hidden_states` and :func:`fused_ce`, the chunked
cross-entropy that never holds ``(B, S, V)`` logits.  Under the train
step's mesh each rank runs the model on plain local tensors, its own rows
(:mod:`repro_torch.sharding.spmd`): :func:`apply_stack` gathers each
block's DTensor weights where it runs it (``spmd.in_use``), and
:func:`fused_ce` takes a DTensor head vocab-parallel
(:class:`_VocabParallelCE`), where the reference hints its logits' vocab
over "model".  No activation is a DTensor, so the reference's activation
hints have no counterpart here.  The cross layers'
context reaches the stack at d_model: a vlm's patches after
:func:`project_ctx`, an audio model's encoder output as it is.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding.hints import is_dtensor
from ..sharding.spmd import in_use
from .base import ModelConfig, ParamDef, check_supported
from . import blocks as B
from . import layers as L

__all__ = [
    "block_schema", "block_cache_schema", "model_schema",
    "model_cache_schema", "apply_mixer", "apply_block",
    "apply_stack", "embed_tokens", "project_ctx", "hidden_states",
    "head_matrix",
    "fused_ce", "lm_head", "forward", "decode_step",
]

# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


def block_schema(cfg: ModelConfig, kind: str = "attn",
                 d_ff_override: int | None = None) -> dict:
    mix = B.mixer_of(kind)
    sch = {"norm1": ParamDef((cfg.d_model,), ("embed",), init="zeros")}
    if mix in ("attn", "global", "local", "bidir"):
        sch["mix"] = B.schema_attn(cfg)
    elif mix == "mla":
        sch["mix"] = B.schema_mla(cfg)
    elif mix == "cross":
        # the context is the frontend stream after frontend_proj (llama-3.2's
        # multi_modal_projector): d_ctx = d_model.  MoLe embedding morphing
        # fuses M^{-1} into frontend_proj alone.
        sch["mix"] = B.schema_cross(cfg, gated=cfg.frontend.cross_gated,
                                    d_ctx=cfg.d_model)
    elif mix == "rec":
        sch["mix"] = B.schema_rec(cfg)
    elif mix == "rwkv":
        rw = B.schema_rwkv(cfg)
        sch["mix"] = rw["tm"]
        sch["ffn"] = rw["cm"]
    elif mix == "dec":
        # whisper's decoder layer: the cross-attention's context is the
        # encoder's output (d_model), not the raw frame stream
        sch["mix"] = B.schema_attn(cfg)
        sch["norm_cross"] = ParamDef((cfg.d_model,), ("embed",), init="zeros")
        sch["cross"] = B.schema_cross(cfg, gated=False, d_ctx=cfg.d_model)
    else:
        raise ValueError(f"unknown mixer kind {kind!r}")
    if B.ffn_of(kind) == "rwkv_cm":
        sch["norm2"] = ParamDef((cfg.d_model,), ("embed",), init="zeros")
    else:
        if not cfg.parallel_block:
            sch["norm2"] = ParamDef((cfg.d_model,), ("embed",), init="zeros")
        if B.ffn_of(kind) == "moe":
            sch["ffn"] = B.schema_moe(cfg)
        else:
            sch["ffn"] = B.schema_ffn(cfg, d_ff=d_ff_override)
    if cfg.post_norm:
        sch["post_norm1"] = ParamDef((cfg.d_model,), ("embed",), init="zeros")
        sch["post_norm2"] = ParamDef((cfg.d_model,), ("embed",), init="zeros")
    return sch


def block_cache_schema(cfg: ModelConfig, kind: str, batch: int,
                       max_len: int) -> dict:
    mix = B.mixer_of(kind)
    if mix in ("attn", "global"):
        return B.cache_attn(cfg, batch, max_len)
    if mix == "local":
        return B.cache_attn(cfg, batch, max_len, cfg.sliding_window)
    if mix == "mla":
        return B.cache_mla(cfg, batch, max_len)
    if mix == "cross":
        return B.cache_cross(cfg, batch)
    if mix == "rec":
        return B.cache_rec(cfg, batch)
    if mix == "rwkv":
        return B.cache_rwkv(cfg, batch)
    if mix == "dec":
        return {"self": B.cache_attn(cfg, batch, max_len),
                "cross": B.cache_cross(cfg, batch)}
    raise ValueError(f"unknown mixer kind {kind!r}")


def _prefix_ff(cfg: ModelConfig) -> int | None:
    return cfg.moe.first_dense_ff if (cfg.moe and cfg.moe.first_dense_ff) else None


def model_schema(cfg: ModelConfig) -> dict:
    check_supported(cfg)
    sch = {"embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                             init="embed", scale=0.02)}
    if cfg.frontend is not None and cfg.family != "audio":
        # an audio model projects its frames by enc_proj, in the encoder
        sch["frontend_proj"] = ParamDef((cfg.frontend.d_in, cfg.d_model),
                                        (None, "embed"), scale=0.02)
    sch["final_norm"] = ParamDef((cfg.d_model,), ("embed",), init="zeros")
    if not cfg.tie_embeddings:
        sch["head"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                               scale=0.02)
    n_prefix = len(cfg.prefix_pattern)
    sch["blocks"] = [
        block_schema(cfg, kind,
                     d_ff_override=_prefix_ff(cfg) if i < n_prefix else None)
        for i, kind in enumerate(cfg.layer_kinds())
    ]
    return sch


def model_cache_schema(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    check_supported(cfg)
    return {"blocks": [block_cache_schema(cfg, kind, batch, max_len)
                       for kind in cfg.layer_kinds()]}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def apply_mixer(p, h: torch.Tensor, cfg: ModelConfig, kind: str,
                rs: B.RunState, cache):
    """The mixer of layer kind ``kind``: ``attn`` / ``global`` attend to
    every earlier position, ``local`` to the last ``cfg.sliding_window``,
    ``bidir`` to every position (the encoder's, no mask), ``mla`` through
    its latent KV; ``cross`` to the context in ``rs``; ``rec`` is the
    RG-LRU recurrence."""
    mix = B.mixer_of(kind)
    if mix in ("attn", "global"):
        return B.apply_attn(p, h, cfg, rs, cache, window=None)
    if mix == "bidir":
        return B.apply_attn(p, h, cfg, rs, cache, window=None, causal=False)
    if mix == "local":
        return B.apply_attn(p, h, cfg, rs, cache, window=cfg.sliding_window)
    if mix == "mla":
        return B.apply_mla(p, h, cfg, rs, cache)
    if mix == "cross":
        return B.apply_cross(p, h, cfg, rs, cache)
    if mix == "rec":
        return B.apply_rec(p, h, cfg, rs, cache)
    raise ValueError(f"unknown mixer kind {kind!r}")


def apply_block(p, h: torch.Tensor, cfg: ModelConfig, rs: B.RunState, cache,
                kind: str = "attn"):
    """One block of layer kind ``kind`` (the reference passes it before
    ``rs``; here it trails, so callers of attention blocks may omit it).
    A gated cross layer scales its attention and its FFN output by the
    tanh of its two 0-d gates, in ``h.dtype``.  A ``dec`` layer runs
    self-attention, cross-attention over ``rs.ctx`` and the FFN, each
    pre-normed (``norm1``, ``norm_cross``, ``norm2``), on its cache
    ``{"self", "cross"}``."""
    if B.mixer_of(kind) == "dec":
        c_self = cache["self"] if cache is not None else None
        c_cross = cache["cross"] if cache is not None else None
        a, c_self = B.apply_attn(p["mix"], L.norm(h, p["norm1"], cfg.norm),
                                 cfg, rs, c_self)
        h = h + a
        a, c_cross = B.apply_cross(p["cross"],
                                   L.norm(h, p["norm_cross"], cfg.norm),
                                   cfg, rs, c_cross)
        h = h + a
        h = h + B.apply_ffn(p["ffn"], L.norm(h, p["norm2"], cfg.norm), cfg)
        return h, ({"self": c_self, "cross": c_cross}
                   if cache is not None else None)

    if B.mixer_of(kind) == "rwkv":
        # time-mix and channel-mix both read and write the layer's cache
        a, cache = B.apply_rwkv_tm(p["mix"], L.norm(h, p["norm1"], cfg.norm),
                                   cfg, rs, cache)
        h = h + a
        fo, cache = B.apply_rwkv_cm(p["ffn"], L.norm(h, p["norm2"], cfg.norm),
                                    cfg, rs, cache)
        return h + fo, cache

    if cfg.parallel_block:  # command-r: shared input norm, attn + ffn in parallel
        n = L.norm(h, p["norm1"], cfg.norm)
        a, cache = apply_mixer(p["mix"], n, cfg, kind, rs, cache)
        fo = B.apply_ffn(p["ffn"], n, cfg)
        return h + a + fo, cache

    gated = B.mixer_of(kind) == "cross" and cfg.frontend.cross_gated
    n = L.norm(h, p["norm1"], cfg.norm)
    a, cache = apply_mixer(p["mix"], n, cfg, kind, rs, cache)
    if cfg.post_norm:
        a = L.norm(a, p["post_norm1"], cfg.norm)
    if gated:
        a = torch.tanh(p["mix"]["gate_attn"]).to(h.dtype) * a
    h = h + a
    n2 = L.norm(h, p["norm2"], cfg.norm)
    if B.ffn_of(kind) == "moe":
        fo = B.apply_moe(p["ffn"], n2, cfg, row_calls=rs.row_calls)
    else:
        fo = B.apply_ffn(p["ffn"], n2, cfg)
    if cfg.post_norm:
        fo = L.norm(fo, p["post_norm2"], cfg.norm)
    if gated:
        fo = torch.tanh(p["mix"]["gate_ffn"]).to(h.dtype) * fo
    return h + fo, cache


def _recomputed(fn, *args):
    """``fn(*args)`` with its activations dropped after the forward and
    recomputed in the backward (``jax.checkpoint`` in the reference).
    Nothing in the model draws random numbers, so no RNG state is kept."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def apply_stack(params, h: torch.Tensor, cfg: ModelConfig, rs: B.RunState,
                caches: dict | None, remat: bool = False):
    """Run every block in order.  Returns (h, caches|None); caches are
    written in place (see :mod:`repro_torch.models.blocks`).

    ``remat`` recomputes each block in the backward instead of keeping its
    activations (the reference checkpoints each scanned group).  It applies
    only without caches and with grad enabled: a block that writes a cache
    in place must run once.  A block of the train step's compute view under
    a mesh (``spmd.Deferred``) is gathered inside its recomputed part, so
    under remat its whole weights live only while it runs."""
    new = [] if caches is not None else None
    kinds = cfg.layer_kinds()
    remat = remat and caches is None and torch.is_grad_enabled()
    for i, p in enumerate(params["blocks"]):
        if remat:
            h = _recomputed(
                lambda x, p=p, k=kinds[i]: apply_block(in_use(p), x, cfg, rs,
                                                       None, k)[0],
                h,
            )
            continue
        c = caches["blocks"][i] if caches is not None else None
        h, nc = apply_block(in_use(p), h, cfg, rs, c, kinds[i])
        if new is not None:
            new.append(nc)
    return h, ({"blocks": new} if caches is not None else None)


# ---------------------------------------------------------------------------
# Full model entry points
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = params["embed"][tokens].to(cfg.adtype)
    if cfg.scale_embedding:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def project_ctx(params, cfg: ModelConfig, ctx: torch.Tensor) -> torch.Tensor:
    """A vlm's cross-layer context: the patch stream (B, Sc, d_in) cast to
    the activation type, through ``frontend_proj`` to d_model."""
    return torch.matmul(ctx.to(cfg.adtype), params["frontend_proj"])


def hidden_states(params, cfg: ModelConfig, tokens: torch.Tensor,
                  ctx: torch.Tensor | None = None,
                  remat: bool = False) -> torch.Tensor:
    """Final-norm'd hidden states (B, S, d): the input to the LM head.
    ``ctx`` is the cross layers' context at d_model (B, Sc, d)."""
    rs = B.RunState(mode="full", ctx=ctx)
    h = embed_tokens(params, tokens, cfg)
    h, _ = apply_stack(params, h, cfg, rs, None, remat=remat)
    return L.norm(h, params["final_norm"], cfg.norm)


def head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def fused_ce(params, cfg: ModelConfig, h: torch.Tensor,
             targets: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Chunked softmax cross-entropy, the mean over the B x S tokens.

    The sequence is cut into ``min(chunk, S)`` positions (one chunk when
    that does not divide S); each chunk's logits are ``h @ w`` in
    ``h.dtype``, then fp32 and the soft-cap, reduced to the sum of
    logsumexp minus the target's logit, and recomputed in the backward, so
    no (B, S, V) tensor outlives its chunk.  The chunks' sums add in order,
    as the reference's scan does.  A DTensor head (the train step's under a
    mesh) makes the sum vocab-parallel (:func:`_vocab_parallel_sum`), the
    reference's logits hinted over "model"; the mean is then over this
    rank's tokens.
    """
    w = head_matrix(params, cfg)
    B_, S, _ = h.shape
    c = min(chunk, S)
    if S % c:
        c = S

    def piece(hc, tc):
        if is_dtensor(w):
            return _vocab_parallel_sum(hc, w, tc, cfg)
        logits = torch.matmul(hc, w.to(hc.dtype))
        logits = L.softcap(logits.float(), cfg.final_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, tc[..., None])[..., 0]
        return torch.sum(lse - picked)

    run = _recomputed if torch.is_grad_enabled() else (lambda fn, *a: fn(*a))
    targets = targets.long()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, c):
        total = total + run(piece, h[:, i : i + c], targets[:, i : i + c])
    return total / (B_ * S)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token ``logsumexp - target logit`` of logits whose vocab is split
    over ``group`` (Megatron's vocab-parallel cross-entropy): the local max
    and sum of exponentials are all-reduced, and the target's logit is taken
    from the rank whose slice ``[lo, lo + V_local)`` holds it.  Every rank of
    the group returns the same (b, c) losses; the backward is
    ``(softmax - onehot) * g`` on the local slice."""

    @staticmethod
    def forward(ctx, logits, targets, lo: int, group):
        import torch.distributed as dist

        v_loc = logits.shape[-1]
        m = logits.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        s = e.sum(dim=-1)
        dist.all_reduce(s, group=group)
        t = targets - lo
        mine = (t >= 0) & (t < v_loc)
        t = torch.where(mine, t, 0)
        picked = torch.gather(logits, -1, t[..., None])[..., 0]
        picked = torch.where(mine, picked, 0.0)
        dist.all_reduce(picked, group=group)
        ctx.save_for_backward(e.div_(s[..., None]), t, mine)
        return torch.log(s) + m - picked

    @staticmethod
    def backward(ctx, g):
        probs, t, mine = ctx.saved_tensors
        grad = probs.clone()
        grad.scatter_add_(-1, t[..., None], -mine[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def _vocab_parallel_sum(hc: torch.Tensor, w, tc: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """A chunk's sum of ``logsumexp - target logit`` on this rank's tokens
    ``hc`` (b, c, d) when the head ``w`` (d, V) is a DTensor whose dp axes
    are gathered (``sharding.spmd.compute_view``).  With its vocab split
    over one mesh dim, each rank takes logits of its slice only and
    :class:`_VocabParallelCE` joins them; the ranks of that dim computed
    ``hc`` alike, so its gradient is summed over them.  Unsplit, it is the
    plain sum on the whole head."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..sharding.spmd import SumGradOver

    mesh = w.device_mesh
    split = [i for i, p in enumerate(w.placements) if p == Shard(1)]
    assert len(split) <= 1, w.placements
    # a dim the head is replicated on saw other tokens: partial gradients
    w_loc = w.to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) else p for p in w.placements])
    if split:
        hc = SumGradOver.apply(hc, mesh.get_group(split[0]))
    logits = torch.matmul(hc, w_loc.to(hc.dtype))
    logits = L.softcap(logits.float(), cfg.final_softcap)
    if not split:
        return torch.sum(torch.logsumexp(logits, dim=-1)
                         - torch.gather(logits, -1, tc[..., None])[..., 0])
    lo = mesh.get_local_rank(split[0]) * w_loc.shape[-1]
    return torch.sum(_VocabParallelCE.apply(logits, tc, lo,
                                            mesh.get_group(split[0])))


def lm_head(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm, then logits contracted in ``h.dtype`` (the head cast to
    it), returned in fp32 after the optional soft-cap."""
    h = L.norm(h, params["final_norm"], cfg.norm)
    w = head_matrix(params, cfg)
    logits = torch.matmul(h, w.to(h.dtype))
    return L.softcap(logits.float(), cfg.final_softcap)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            caches: dict | None = None, write_cache: bool = False,
            remat: bool = False, ctx: torch.Tensor | None = None):
    """Full-sequence forward (prefill).  Returns (logits, caches).
    ``ctx`` is the cross layers' context at d_model (B, Sc, d)."""
    rs = B.RunState(mode="full", ctx=ctx, write_cache=write_cache)
    h = embed_tokens(params, tokens, cfg)
    h, new_caches = apply_stack(params, h, cfg, rs, caches, remat=remat)
    return lm_head(params, h, cfg), new_caches


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, t,
                caches: dict):
    """One-token decode: token (B, 1) at position ``t`` (int or (B,))."""
    rs = B.RunState(mode="decode", t=t)
    h = embed_tokens(params, token, cfg)
    h, new_caches = apply_stack(params, h, cfg, rs, caches)
    return lm_head(params, h, cfg), new_caches
