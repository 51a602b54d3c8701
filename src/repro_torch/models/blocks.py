"""Per-layer blocks on PyTorch: the dense self-attention block (global, or
in a sliding window with a ring-buffer cache), DeepSeek-V2's multi-head
latent attention (MLA), the dense and the fine-grained MoE FFN, the
RG-LRU recurrent mixer of RecurrentGemma (temporal conv + gated linear
recurrence), the cross-attention mixer of a vision-language stack, and
the RWKV-6 block (time-mix + channel-mix).

Ported from ``repro.models.blocks`` (``RunState``, ``mixer_of``/``ffn_of``,
the dense FFN, the MoE FFN in its capacity-buffer form, the self-attention,
MLA, RG-LRU and cross-attention mixers, and the RWKV-6 time-mix and
channel-mix).  Whisper's ``bidir`` encoder layers and ``dec`` decoder
layers are assembled from these mixers in
:mod:`repro_torch.models.stack`.  Under the train step's mesh an MoE FFN
whose experts split over "model" runs the expert-parallel form
(``_apply_moe_sharded``, the reference's ``shard_map`` EP), on each rank's
own tokens.  The RWKV-6 time-mix
runs its prefill scan through K6
(:func:`repro_torch.kernels.wkv6.wkv6_chunked`), and in training through
:func:`repro_torch.kernels.wkv6.wkv6_scan`, whose backward is hand-written
kernels too; the reference's
``_wkv_intra_subchunked`` (an XLA form selected by ``subchunk > 0``) is not
ported, since K6 replaces both of the reference's XLA forms on the card.

Caches differ from the reference in two ways, both because torch updates in
place where JAX returns new arrays:

  * a block **writes its cache tensors in place** (prefill and decode) and
    returns the same dict, so the decode lane's joiner prefills straight
    into its row's slice of the ``(R, ...)`` caches (the RWKV state ``s``
    and the token-shift rows ``tm_x``/``cm_x`` too);
  * ``pos`` (absolute position held by each cache slot, -1 = empty) is kept
    per batch row, ``(B, slots)``, so every row of a batched decode step
    masks by its own position ``t[r]``.  The reference keeps one ``(slots,)``
    vector per B-row cache and vmaps over rows to get the same effect.
    MLA's cache (``ckv``, ``kr``) has no ``pos``: a row's positions up to
    its own ``t[r]`` are valid.  An RG-LRU cache (``h``, ``conv``) is each
    row's own recurrence and reads no position.  A cross-attention cache
    (``k``, ``v`` of the context's positions) is written by the prefill
    and only read by decode.

The reference's vmapped lane step also routes each row's token through an
MoE FFN as a call of its own; :class:`RunState` ``row_calls`` says so here,
where the rows run as one batch (:func:`moe_route`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.wkv6 import wkv6_chunked, wkv6_scan
from ..sharding.hints import is_dtensor
from .base import ModelConfig, ParamDef
from . import layers as L

__all__ = [
    "RunState", "mixer_of", "ffn_of", "schema_ffn", "apply_ffn",
    "schema_moe", "moe_capacity", "Route", "moe_route", "apply_moe",
    "schema_attn", "cache_attn", "apply_attn", "schema_mla", "cache_mla",
    "apply_mla", "schema_rec", "cache_rec", "apply_rec", "schema_cross",
    "cache_cross", "apply_cross", "schema_rwkv",
    "cache_rwkv", "apply_rwkv_tm", "apply_rwkv_cm",
]


@dataclasses.dataclass
class RunState:
    mode: str                       # "full" | "decode"
    # decode: position being written — an int for the whole batch, or a
    # (B,) tensor of per-row positions (the batched decode lane).
    t: int | torch.Tensor | None = None
    # cross-attention context (B, Sc, d_ctx): full mode only (decode reads
    # the cross caches the prefill wrote)
    ctx: torch.Tensor | None = None
    write_cache: bool = False       # prefill: write caches in full mode
    # MoE routing: each batch row is a call of its own, with its own
    # capacity (the decode lane's rows, which the reference vmaps); else
    # the whole batch is one call.
    row_calls: bool = False


def mixer_of(kind: str) -> str:
    return kind[: -len("_moe")] if kind.endswith("_moe") else kind


def ffn_of(kind: str) -> str:
    if kind.endswith("_moe"):
        return "moe"
    if kind == "rwkv":
        return "rwkv_cm"
    return "dense"


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def schema_ffn(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    if cfg.act == "gelu":  # plain (ungated) MLP, whisper-style
        return {"wi_up": ParamDef((d, f), ("embed", "ffn")),
                "wo": ParamDef((f, d), ("ffn", "embed"))}
    return {
        "wi_gate": ParamDef((d, f), ("embed", "ffn")),
        "wi_up": ParamDef((d, f), ("embed", "ffn")),
        "wo": ParamDef((f, d), ("ffn", "embed")),
    }


def apply_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "gelu":
        h = L.act_fn("gelu")(torch.matmul(x, p["wi_up"]))
        return torch.matmul(h, p["wo"])
    return L.gated_mlp(x, p["wi_gate"], p["wi_up"], p["wo"], cfg.act)


# ---------------------------------------------------------------------------
# MoE FFN (fine-grained routed experts + shared experts)
# ---------------------------------------------------------------------------


def schema_moe(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_routed
    sch = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02),
        "wg": ParamDef((e, d, f), ("experts", "embed", "ffn")),
        "wu": ParamDef((e, d, f), ("experts", "embed", "ffn")),
        "wd": ParamDef((e, f, d), ("experts", "ffn", "embed")),
    }
    if m.n_shared:
        sch["shared"] = schema_ffn(cfg, d_ff=m.n_shared * f)
    return sch


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for one call of ``n_tokens`` tokens."""
    m = cfg.moe
    c = math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_routed)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


class Route(NamedTuple):
    """Where each of T tokens' top-k assignments goes (token-major: token,
    then rank within its top-k)."""

    probs: torch.Tensor     # (T, E) fp32 router softmax
    top_p: torch.Tensor     # (T, k) fp32, descending
    top_i: torch.Tensor     # (T, k) expert ids
    keep: torch.Tensor      # (T*k,) bool: False = dropped (over capacity)
    slot: torch.Tensor      # (T*k,) slot in the expert's buffer (C-1 if dropped)
    capacity: int           # C: the buffer's slots per expert


def moe_route(p, xf: torch.Tensor, cfg: ModelConfig, calls: int = 1) -> Route:
    """Route ``xf`` (T, d), ``calls`` equal calls of T / calls tokens each.

    The router product, softmax and top-k are fp32.  An assignment's rank
    in its expert is its place in token-major order within its call; it is
    dropped when that rank reaches ``moe_capacity`` of the call's tokens.
    With one call the rank is its slot (``_apply_moe_dense``).  With more,
    each call routes as if alone and the kept assignments of all calls
    share one buffer, slotted in token-major order: no call's routing
    depends on another's."""
    m = cfg.moe
    T = xf.shape[0]
    logits = torch.matmul(xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)     # (T, k) descending
    if m.norm_topk:
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    e_flat = top_i.reshape(-1)
    onehot = F.one_hot(e_flat, m.n_routed)                # (T*k, E)
    per_call = T // calls
    C = moe_capacity(per_call, cfg)
    rank = torch.cumsum(onehot.reshape(calls, -1, m.n_routed), dim=1)
    pos = torch.gather(rank.reshape(T * m.top_k, m.n_routed), 1,
                       e_flat[:, None])[:, 0] - 1
    keep = pos < C
    if calls > 1:
        kept = torch.cumsum(onehot * keep[:, None], dim=0)
        pos = torch.gather(kept, 1, e_flat[:, None])[:, 0] - 1
        C = min(T, calls * C)
    slot = torch.where(keep, pos, C - 1)
    return Route(probs, top_p, top_i, keep, slot, C)


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig,
              row_calls: bool = False) -> torch.Tensor:
    """MoE FFN dispatcher (the reference's).

    Weights that are DTensors run the expert-parallel form
    (:func:`_apply_moe_sharded`: each rank dispatches only its local tokens
    to its local experts, and the partial outputs are summed over
    "model").  The reference's dispatcher reads the ambient mesh; here the
    train step's compute view (:func:`repro_torch.sharding.spmd.
    compute_view`) keeps an MoE FFN as DTensors exactly where the
    reference takes that form, and gathers it whole where the reference
    falls back to the dense form.  Plain weights run the capacity-buffer
    form below (:func:`_apply_moe_dense`), the decode lane's rows
    (``row_calls``) included."""
    if is_dtensor(p["wg"]):
        return _apply_moe_sharded(p, x, cfg)
    return _apply_moe_dense(p, x, cfg, row_calls)


def _apply_moe_dense(p, x: torch.Tensor, cfg: ModelConfig,
                     row_calls: bool = False) -> torch.Tensor:
    """Capacity-buffer MoE (GShard-style scatter dispatch): x (B, S, d).

    The whole batch routes as one call of B*S tokens, or with
    ``row_calls`` each row as a call of S tokens (:func:`moe_route`).
    Kept assignments are scattered into an ``(E, C, d)`` buffer; dropped
    ones are zeroed first and add nothing, to the output or its gradient.
    The three expert products run over the buffer in ``x.dtype``; each
    token's outputs are weighted by its top-k probabilities cast to that
    type and summed over k, and the shared experts (one FFN of width
    ``n_shared * d_ff_expert``) are added."""
    m = cfg.moe
    B_, S, d = x.shape
    T = B_ * S
    xf = x.reshape(T, d)
    r = moe_route(p, xf, cfg, calls=B_ if row_calls else 1)
    e_flat = r.top_i.reshape(-1)
    keep = r.keep[:, None].to(xf.dtype)
    tok = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
    buf = xf.new_zeros((m.n_routed, r.capacity, d)).index_put(
        (e_flat, r.slot), xf[tok] * keep, accumulate=True)
    g = L.act_fn(cfg.act)(torch.bmm(buf, p["wg"]))
    u = torch.bmm(buf, p["wu"])
    out_buf = torch.bmm(g * u, p["wd"])                    # (E, C, d)
    picked = out_buf[e_flat, r.slot] * keep
    w = r.top_p.reshape(-1).to(xf.dtype)
    y = torch.sum((picked * w[:, None]).reshape(T, m.top_k, d), dim=1)
    if m.n_shared:
        y = y + apply_ffn(p["shared"], xf, cfg)
    return y.reshape(B_, S, d)


def _moe_local_tokens(p_local, xf: torch.Tensor, cfg: ModelConfig,
                      e_lo: int, n_local: int) -> torch.Tensor:
    """One rank's expert-parallel dispatch: its tokens ``xf`` (T, d) routed
    over all experts (``p_local["router"]`` is whole; capacity of T tokens),
    the assignments to its ``n_local`` experts ``[e_lo, e_lo + n_local)``
    (``p_local``'s ``wg``/``wu``/``wd``) kept; returns this rank's PARTIAL
    output (T, d).  An assignment's slot is its rank among the expert's
    assignments in token-major order, as in the dense form, so with every
    expert local this is :func:`_apply_moe_dense`'s routed part."""
    m = cfg.moe
    T, d = xf.shape
    r = moe_route(p_local, xf, cfg)
    local = r.top_i.reshape(-1) - e_lo
    keep = r.keep & (local >= 0) & (local < n_local)
    e_c = torch.where(keep, local, 0)
    slot = torch.where(keep, r.slot, r.capacity - 1)
    keepf = keep[:, None].to(xf.dtype)
    tok = torch.arange(T, device=xf.device).repeat_interleave(m.top_k)
    buf = xf.new_zeros((n_local, r.capacity, d)).index_put(
        (e_c, slot), xf[tok] * keepf, accumulate=True)
    g = L.act_fn(cfg.act)(torch.bmm(buf, p_local["wg"]))
    u = torch.bmm(buf, p_local["wu"])
    out_buf = torch.bmm(g * u, p_local["wd"])
    picked = out_buf[e_c, slot] * keepf
    w = r.top_p.reshape(-1).to(xf.dtype)
    return torch.sum((picked * w[:, None]).reshape(T, m.top_k, d), dim=1)


def _local(t, mesh, spec):
    """The local shard of the DTensor ``t`` under ``spec``, whose gradient
    comes back as a partial sum over the mesh dims ``spec`` replicates it
    on: each rank uses it on other tokens or experts."""
    from torch.distributed.tensor import Partial, Replicate

    from ..sharding.rules import placements

    t = t.redistribute(mesh, placements(mesh, spec))
    return t.to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) else p for p in t.placements])


def _apply_moe_sharded(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Expert parallelism (the reference's ``shard_map`` form): tokens
    split over the dp axes, experts over "model"; each rank runs
    :func:`_moe_local_tokens` on its (tokens x experts) block, the shared
    experts row-parallel over "model" (their partial sums join the routed
    ones), and one all-reduce over "model" sums the partial outputs.

    ``x`` (b, S, d) is this rank's own tokens, a plain tensor, as a rank of
    the train step holds them; so is the result.  The weights are DTensors
    on the mesh whose "model" size divides ``n_routed`` (any placement:
    each is redistributed to its spec)."""
    from ..sharding.spmd import SumGradOver, SumOver

    m = cfg.moe
    mesh = p["wg"].device_mesh
    model = mesh.get_group("model")
    n_local = m.n_routed // mesh.size(mesh.mesh_dim_names.index("model"))
    w_spec = {"router": (None, None), "wg": ("model", None, None),
              "wu": ("model", None, None), "wd": ("model", None, None)}
    p_loc = {k: _local(p[k], mesh, spec) for k, spec in w_spec.items()}
    Bl, S, d = x.shape
    # the ranks of "model" hold the same tokens; each one's gradient of
    # them is its experts' share
    xf = SumGradOver.apply(x.reshape(Bl * S, d), model)
    e_lo = mesh.get_local_rank("model") * n_local
    y = _moe_local_tokens(p_loc, xf, cfg, e_lo, n_local)
    if m.n_shared:
        sh = {"wi_gate": (None, "model"), "wi_up": (None, "model"),
              "wo": ("model", None)}
        y = y + apply_ffn({k: _local(p["shared"][k], mesh, spec)
                           for k, spec in sh.items()}, xf, cfg)
    return SumOver.apply(y, model).reshape(Bl, S, d)   # psum over "model"


# ---------------------------------------------------------------------------
# Self-attention mixer
# ---------------------------------------------------------------------------


def schema_attn(cfg: ModelConfig) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sch = {
        "wq": ParamDef((d, H, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((H, hd, d), ("heads", None, "embed"), scale=0.02),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamDef((H, hd), ("heads", None), init="zeros")
        sch["bk"] = ParamDef((Hkv, hd), ("kv_heads", None), init="zeros")
        sch["bv"] = ParamDef((Hkv, hd), ("kv_heads", None), init="zeros")
    return sch


def cache_attn(cfg: ModelConfig, batch: int, max_len: int,
               window: int | None = None) -> dict:
    """One slot per position up to ``max_len`` for global attention; a
    ring of ``min(max_len, window)`` slots for a sliding-window layer
    (position ``p`` lives in slot ``p % slots``).  ``pos`` holds each
    slot's absolute position, -1 = empty."""
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    slots = min(max_len, window) if window else max_len
    return {
        "k": ParamDef((batch, slots, Hkv, hd),
                      ("batch", "kv_seq", "kv_heads", None), init="zeros"),
        "v": ParamDef((batch, slots, Hkv, hd),
                      ("batch", "kv_seq", "kv_heads", None), init="zeros"),
        "pos": ParamDef((batch, slots), ("batch", None), init="neg_ones",
                        dtype=torch.int32),
    }


def _qkv(p, h: torch.Tensor, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _row_positions(t, batch: int, device) -> torch.Tensor:
    """Decode position(s) as a (B,) int64 tensor."""
    t = torch.as_tensor(t, device=device).to(torch.int64)
    return t.expand(batch) if t.dim() == 0 else t


def apply_attn(
    p, h: torch.Tensor, cfg: ModelConfig, rs: RunState,
    cache: dict | None, *, window: int | None = None, causal: bool = True,
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention, global (``window=None``) or in a sliding window of
    ``window`` positions, whose cache is a ring (:func:`cache_attn`)."""
    B = h.shape[0]
    q, k, v = _qkv(p, h, cfg)

    if rs.mode == "decode":
        t = _row_positions(rs.t, B, h.device)
        q = L.rope(q, t[:, None], cfg.rope_theta)
        k = L.rope(k, t[:, None], cfg.rope_theta)
        rows = torch.arange(B, device=h.device)
        kc, vc, pos = cache["k"], cache["v"], cache["pos"]
        slot = t % kc.shape[1] if window else t
        kc[rows, slot] = k[:, 0].to(kc.dtype)
        vc[rows, slot] = v[:, 0].to(vc.dtype)
        pos[rows, slot] = t.to(pos.dtype)
        # mask by recorded absolute positions, each row at its own t (a
        # ring slot holds whichever position wrote it last)
        valid = (pos >= 0) & (pos <= t[:, None])
        if window:
            valid &= pos > t[:, None] - window
        qg = q.reshape(B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                       cfg.head_dim)
        s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), kc.float())
        scale = (cfg.attn_scale if cfg.attn_scale is not None
                 else cfg.head_dim ** -0.5)
        s = L.softcap(s * scale, cfg.attn_softcap)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        w = torch.softmax(s, dim=-1).to(vc.dtype)
        o = torch.einsum("bhgk,bkhd->bhgd", w, vc).reshape(
            B, 1, cfg.n_heads, cfg.head_dim
        )
        new_cache = cache
    else:
        S = h.shape[1]
        positions = torch.arange(S, device=h.device)
        q = L.rope(q, positions[None], cfg.rope_theta)
        k = L.rope(k, positions[None], cfg.rope_theta)
        # dense up to dense_attn_max_seq, the flash scan above it
        o = L.attention(
            q, k, v, causal=causal, window=window, logit_cap=cfg.attn_softcap,
            dense_max_seq=cfg.dense_attn_max_seq, block_kv=cfg.flash_block_kv,
            scale=cfg.attn_scale,
        )
        new_cache = None
        if cache is not None and rs.write_cache:
            slots = cache["k"].shape[1]
            if S > slots and not window:
                raise ValueError(
                    f"prefill of {S} positions exceeds the cache's {slots}"
                )
            if S <= slots:
                idx, ps = slice(0, S), positions
            else:
                # a window's ring keeps the last ``slots`` positions,
                # position p in slot p % slots, as the decode writes go on
                ps = positions[S - slots:]
                idx = ps % slots
            cache["k"][:, idx] = k[:, S - len(ps):].to(cache["k"].dtype)
            cache["v"][:, idx] = v[:, S - len(ps):].to(cache["v"].dtype)
            cache["pos"][:, idx] = ps.to(cache["pos"].dtype)
            new_cache = cache

    out = torch.einsum("bshk,hkd->bsd", o.to(h.dtype), p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# Cross-attention mixer (the vlm's "cross" layers)
# ---------------------------------------------------------------------------


def schema_cross(cfg: ModelConfig, gated: bool, d_ctx: int) -> dict:
    """Queries from the residual stream, keys and values from a context of
    width ``d_ctx``, the context's RMSNorm scale ``ctx_norm``, and with
    ``gated`` the two 0-d tanh gates of the block (attention and FFN), zero
    at init."""
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sch = {
        "wq": ParamDef((d, H, hd), ("embed", "heads", None)),
        "wk": ParamDef((d_ctx, Hkv, hd), (None, "kv_heads", None)),
        "wv": ParamDef((d_ctx, Hkv, hd), (None, "kv_heads", None)),
        "wo": ParamDef((H, hd, d), ("heads", None, "embed"), scale=0.02),
        "ctx_norm": ParamDef((d_ctx,), (None,), init="zeros"),
    }
    if gated:
        sch["gate_attn"] = ParamDef((), (), init="zeros")
        sch["gate_ffn"] = ParamDef((), (), init="zeros")
    return sch


def cache_cross(cfg: ModelConfig, batch: int) -> dict:
    """The context's keys and values, one slot per context position."""
    shape = (batch, cfg.frontend.n_tokens, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", None, "kv_heads", None)
    return {"k": ParamDef(shape, axes, init="zeros"),
            "v": ParamDef(shape, axes, init="zeros")}


def apply_cross(
    p, h: torch.Tensor, cfg: ModelConfig, rs: RunState, cache: dict | None
) -> tuple[torch.Tensor, dict | None]:
    """Cross-attention of ``h`` over the context: full mode projects
    ``rms_norm(rs.ctx, ctx_norm)`` (RMSNorm whatever ``cfg.norm``) to K and
    V and, under ``write_cache``, writes them into the cache in place;
    decode reads the cache and never sees the context.  Every query
    attends to every context position (no mask, no RoPE on either side):
    dense GQA attention with fp32 scores at any length, as the
    reference's."""
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if rs.mode == "decode":
        k, v = cache["k"], cache["v"]      # the context's K/V from prefill
        new_cache = cache
    else:
        ctx = L.rms_norm(rs.ctx, p["ctx_norm"])
        k = torch.einsum("bsd,dhk->bshk", ctx, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", ctx, p["wv"])
        new_cache = None
        if cache is not None and rs.write_cache:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
            new_cache = cache
    o = L.dense_attention(q, k, v, causal=False)
    out = torch.einsum("bshk,hkd->bsd", o.to(h.dtype), p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA mixer (DeepSeek-V2)
# ---------------------------------------------------------------------------


def schema_mla(cfg: ModelConfig) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    a = cfg.mla
    return {
        "wq": ParamDef((d, H, a.qk_nope + a.qk_rope),
                       ("embed", "heads", None)),
        "w_dkv": ParamDef((d, a.kv_lora), ("embed", "lora")),
        "w_kr": ParamDef((d, a.qk_rope), ("embed", None)),
        "kv_norm": ParamDef((a.kv_lora,), ("lora",), init="zeros"),
        "w_uk": ParamDef((a.kv_lora, H, a.qk_nope),
                         ("lora", "heads", None)),
        "w_uv": ParamDef((a.kv_lora, H, a.v_head),
                         ("lora", "heads", None)),
        "wo": ParamDef((H, a.v_head, d), ("heads", None, "embed"),
                       scale=0.02),
    }


def cache_mla(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The compressed KV cache: the normed latent ``ckv`` and the roped key
    ``kr`` of each position (no ``pos``, no ring)."""
    a = cfg.mla
    return {
        "ckv": ParamDef((batch, max_len, a.kv_lora), ("batch", "kv_seq", "lora"),
                        init="zeros"),
        "kr": ParamDef((batch, max_len, a.qk_rope), ("batch", "kv_seq", None),
                       init="zeros"),
    }


def apply_mla(
    p, h: torch.Tensor, cfg: ModelConfig, rs: RunState, cache: dict | None
) -> tuple[torch.Tensor, dict | None]:
    """MLA: the full (decompressed) form for training and prefill; the
    *absorbed* form for decode, whose cache holds only ``(c_kv, k_rope)``
    per position and folds ``W_uk`` / ``W_uv`` into the score and output
    products (scores, softmax and the latent context in fp32).  Decode
    positions may differ per row (``t`` of shape (B,))."""
    a = cfg.mla
    B_ = h.shape[0]
    H = cfg.n_heads
    scale = (a.qk_nope + a.qk_rope) ** -0.5

    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    q_nope, q_rope = q[..., : a.qk_nope], q[..., a.qk_nope :]

    if rs.mode == "decode":
        t = _row_positions(rs.t, B_, h.device)
        q_rope = L.rope(q_rope, t[:, None], cfg.rope_theta)
        ckv_new = L.rms_norm(torch.matmul(h, p["w_dkv"]), p["kv_norm"])
        kr_new = L.rope(torch.matmul(h, p["w_kr"])[:, :, None], t[:, None],
                        cfg.rope_theta)[:, :, 0]
        ckv, kr = cache["ckv"], cache["kr"]
        rows = torch.arange(B_, device=h.device)
        ckv[rows, t] = ckv_new[:, 0].to(ckv.dtype)
        kr[rows, t] = kr_new[:, 0].to(kr.dtype)
        # absorbed scores: q_eff = q_nope @ W_uk -> (B, H, lora)
        q_eff = torch.einsum("bshk,lhk->bhl", q_nope, p["w_uk"])
        ckv32 = ckv.float()
        s = torch.einsum("bhl,btl->bht", q_eff.float(), ckv32)
        s = s + torch.einsum("bshr,btr->bht", q_rope.float(), kr.float())
        s = s * scale
        valid = (torch.arange(ckv.shape[1], device=h.device)[None]
                 <= t[:, None])
        s = s.masked_fill(~valid[:, None, :], float("-inf"))
        w = torch.softmax(s, dim=-1)
        ctx_l = torch.einsum("bht,btl->bhl", w, ckv32)        # (B, H, lora)
        # absorbed V up-projection, fp32 (the reference's product promotes)
        o = torch.einsum("bhl,lhv->bhv", ctx_l, p["w_uv"].float())
        o = o[:, None].to(h.dtype)                            # (B, 1, H, v)
        new_cache = cache
    else:
        S = h.shape[1]
        positions = torch.arange(S, device=h.device)[None]
        q_rope = L.rope(q_rope, positions, cfg.rope_theta)
        ckv = L.rms_norm(torch.matmul(h, p["w_dkv"]), p["kv_norm"])
        kr = L.rope(torch.matmul(h, p["w_kr"])[:, :, None], positions,
                    cfg.rope_theta)
        k_nope = torch.einsum("bsl,lhk->bshk", ckv, p["w_uk"])
        v = torch.einsum("bsl,lhv->bshv", ckv, p["w_uv"])
        qf = torch.cat([q_nope, q_rope], dim=-1)
        kf = torch.cat([k_nope, kr.expand(B_, S, H, a.qk_rope)], dim=-1)
        pad = a.qk_nope + a.qk_rope - a.v_head
        vp = F.pad(v, (0, pad)) if pad else v
        o = L.attention(
            qf, kf, vp, causal=True, logit_cap=None, scale=scale,
            dense_max_seq=cfg.dense_attn_max_seq, block_kv=cfg.flash_block_kv,
        )[..., : a.v_head]
        new_cache = None
        if cache is not None and rs.write_cache:
            if S > cache["ckv"].shape[1]:
                raise ValueError(f"prefill of {S} positions exceeds the "
                                 f"cache's {cache['ckv'].shape[1]}")
            # the reference writes zeros_like(cache) with the prompt's
            # positions set: positions past S are emptied too
            for name, x in (("ckv", ckv), ("kr", kr[:, :, 0])):
                cache[name][:, :S] = x.to(cache[name].dtype)
                cache[name][:, S:] = 0
            new_cache = cache

    out = torch.einsum("bshv,hvd->bsd", o, p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# RG-LRU recurrent mixer (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------


def schema_rec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    r = cfg.rnn
    dr = r.d_rnn or d
    nb = 16  # block-diagonal gate blocks (RecurrentGemma-style)
    bw = dr // nb
    return {
        "w_y": ParamDef((d, dr), ("embed", "rnn")),
        "w_x": ParamDef((d, dr), ("embed", "rnn")),
        "conv_w": ParamDef((r.conv_width, dr), (None, "rnn"), scale=0.02),
        "conv_b": ParamDef((dr,), ("rnn",), init="zeros"),
        "gate_a": ParamDef((nb, bw, bw), ("rnn", None, None)),
        "gate_a_b": ParamDef((dr,), ("rnn",), init="zeros"),
        "gate_x": ParamDef((nb, bw, bw), ("rnn", None, None)),
        "gate_x_b": ParamDef((dr,), ("rnn",), init="zeros"),
        "lam": ParamDef((dr,), ("rnn",), init="normal", scale=0.5),
        "w_out": ParamDef((dr, d), ("rnn", "embed"), scale=0.02),
    }


def cache_rec(cfg: ModelConfig, batch: int) -> dict:
    """The recurrence's state ``h`` (fp32) and the last ``conv_width - 1``
    inputs of the temporal conv, ``conv`` (oldest first, in the activation
    type)."""
    r = cfg.rnn
    dr = r.d_rnn or cfg.d_model
    return {
        "h": ParamDef((batch, dr), ("batch", "rnn"), init="zeros",
                      dtype=torch.float32),
        "conv": ParamDef((batch, r.conv_width - 1, dr), ("batch", None, "rnn"),
                         init="zeros"),
    }


def _block_diag_gate(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """x: (..., dr) -> sigmoid(blockdiag(w) x + b), fp32; w: (nb, bw, bw).
    The bias is added in the input's type, then cast to fp32."""
    nb, bw, _ = w.shape
    lead = x.shape[:-1]
    xb = x.reshape(*lead, nb, bw)
    y = torch.einsum("...nb,nbc->...nc", xb, w).reshape(*lead, nb * bw)
    return torch.sigmoid((y + b).float())


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _decay_and_input(z: torch.Tensor, p, c: float):
    """The RG-LRU's per-step decay ``a`` and input ``b`` (fp32) from the
    conv output ``z``: log a = -c softplus(lam) r_gate, and
    b = sqrt(max(1 - exp(2 log a), 1e-12)) (z i_gate)."""
    r_gate = _block_diag_gate(z, p["gate_a"], p["gate_a_b"])  # recurrence
    i_gate = _block_diag_gate(z, p["gate_x"], p["gate_x_b"])  # input
    log_a = -c * _softplus(p["lam"].float()) * r_gate
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        z.float() * i_gate
    )
    return a, b


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0, by doubling:
    after the step of offset d, each position holds the recurrence over
    the last 2d positions ending at it (the decay product in ``a``, the
    partial sum in ``b``); ceil(log2 S) steps of whole-tensor ops.  The
    reference's ``jax.lax.associative_scan`` combines the same pairs in
    another order, so fp32 results differ by rounding."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])],
                      dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


class _LinearScan(torch.autograd.Function):
    """:func:`_doubling_scan` with its gradient as a scan in reverse.

    For h_t = a_t h_{t-1} + b_t and g_t = dL/dh_t (through every later
    state), g_t = dh_t + a_{t+1} g_{t+1}: the same recurrence over the
    flipped sequence with the decays shifted by one (a_{t+1}, none past
    the end).  Then dL/db_t = g_t and dL/da_t = g_t h_{t-1}, h_{-1} = 0.
    Only ``a`` and the output ``h`` are kept for the backward, where
    autograd through the doubling keeps two tensors of the input's size a
    step and runs about three times the forward's ops."""

    @staticmethod
    def forward(ctx, a, b):
        h = _doubling_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        zero = torch.zeros_like(a[:, :1])
        a_next = torch.cat([zero, a[:, 1:].flip(1)], dim=1)
        g = _doubling_scan(a_next, dh.flip(1)).flip(1)
        da = g * torch.cat([zero, h[:, :-1]], dim=1)
        return da, g


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0
    (:class:`_LinearScan`)."""
    return _LinearScan.apply(a, b)


def _rglru(z: torch.Tensor, p, cfg: ModelConfig,
           h0: torch.Tensor | None):
    """RG-LRU over (B, S, dr) in fp32; returns (every position's state,
    the last).  ``h0`` is folded into the first step: b_0 += a_0 h0."""
    a, b = _decay_and_input(z, p, cfg.rnn.c)
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0.float()
    h = _linear_scan(a, b)
    return h, h[:, -1]


def apply_rec(
    p, h: torch.Tensor, cfg: ModelConfig, rs: RunState, cache: dict | None
) -> tuple[torch.Tensor, dict | None]:
    """The RG-LRU mixer: out = (gelu(h W_y) * rglru(conv(h W_x))) W_out.

    Full mode runs the temporal conv over the sequence padded with
    ``conv_width - 1`` zeros in front (a sum of ``conv_width`` products,
    then the bias) and the recurrence as a scan; with a cache and without
    ``write_cache`` it starts from the cache's ``h``, as the reference's.
    A prefill writes the last state and the last ``conv_width - 1`` inputs
    of the conv, right-aligned, with zeros to the left of a prompt shorter
    than that: the reference writes ``z[:, -(W-1):]``, which is then short
    and which its decode cannot read; zeros are what its own full-sequence
    conv puts before position 0.  Decode runs the conv as one contraction
    over (conv ++ z) and one step of the recurrence."""
    r = cfg.rnn
    W = r.conv_width
    y = L.act_fn("gelu")(torch.matmul(h, p["w_y"]))
    z = torch.matmul(h, p["w_x"])

    if rs.mode == "decode":
        zc = torch.cat([cache["conv"], z], dim=1)               # (B, W, dr)
        z1 = torch.einsum("bwr,wr->br", zc, p["conv_w"]) + p["conv_b"]
        a, b = _decay_and_input(z1, p, r.c)
        hn = a * cache["h"].float() + b
        out = torch.matmul(y[:, 0] * hn.to(h.dtype), p["w_out"])
        cache["h"].copy_(hn)
        cache["conv"].copy_(zc[:, 1:])
        return out[:, None], cache

    S = z.shape[1]
    zp = F.pad(z, (0, 0, W - 1, 0))
    zc = sum(zp[:, i : i + S] * p["conv_w"][i] for i in range(W)) + p["conv_b"]
    h0 = cache["h"] if (cache is not None and not rs.write_cache) else None
    hseq, h_last = _rglru(zc, p, cfg, h0)
    out = torch.matmul(y * hseq.to(h.dtype), p["w_out"])
    new_cache = None
    if cache is not None and rs.write_cache:
        n = min(S, W - 1)
        cache["h"].copy_(h_last)
        cache["conv"].zero_()
        cache["conv"][:, W - 1 - n :] = z[:, S - n :].to(cache["conv"].dtype)
        new_cache = cache
    return out, new_cache


# ---------------------------------------------------------------------------
# RWKV-6 (Finch) — time-mix (chunked linear attention) + channel-mix
# ---------------------------------------------------------------------------


def schema_rwkv(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.rwkv
    H = d // w.head_dim
    rank = w.ddlerp_rank
    return {
        "tm": {
            "maa_x": ParamDef((d,), ("embed",), init="zeros"),
            # w,k,v,r,g
            "maa": ParamDef((5, d), (None, "embed"), init="zeros"),
            "A": ParamDef((d, 5 * rank), ("embed", None), scale=0.02),
            "B": ParamDef((5, rank, d), (None, None, "embed"), scale=0.02),
            "w0": ParamDef((d,), ("embed",), init="normal", scale=1.0),
            "w1": ParamDef((d, w.decay_rank), ("embed", None), scale=0.02),
            "w2": ParamDef((w.decay_rank, d), (None, "embed"), scale=0.02),
            "u": ParamDef((H, w.head_dim), ("heads", None), scale=0.5),
            "wr": ParamDef((d, d), ("embed", "rnn")),
            "wk": ParamDef((d, d), ("embed", "rnn")),
            "wv": ParamDef((d, d), ("embed", "rnn")),
            "wg": ParamDef((d, d), ("embed", "rnn")),
            "ln_w": ParamDef((d,), ("embed",), init="ones"),
            "ln_b": ParamDef((d,), ("embed",), init="zeros"),
            "wo": ParamDef((d, d), ("rnn", "embed"), scale=0.02),
        },
        "cm": {
            "maa_k": ParamDef((d,), ("embed",), init="zeros"),
            "maa_r": ParamDef((d,), ("embed",), init="zeros"),
            "wk": ParamDef((d, cfg.d_ff), ("embed", "ffn")),
            "wv": ParamDef((cfg.d_ff, d), ("ffn", "embed"), scale=0.02),
            "wr": ParamDef((d, d), ("embed", "rnn"), scale=0.02),
        },
    }


def cache_rwkv(cfg: ModelConfig, batch: int) -> dict:
    """The recurrent state ``s`` (key x value, fp32) and the last token of
    each mixer's input (token shift)."""
    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    H = d // hd
    return {
        "s": ParamDef((batch, H, hd, hd), ("batch", "heads", None, None),
                      init="zeros", dtype=torch.float32),
        "tm_x": ParamDef((batch, d), ("batch", "embed"), init="zeros"),
        "cm_x": ParamDef((batch, d), ("batch", "embed"), init="zeros"),
    }


def _ddlerp(p, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift interpolation -> (xw, xk, xv, xr, xg)."""
    dx = x_prev - x
    xx = x + dx * p["maa_x"]
    a = torch.tanh(torch.matmul(xx, p["A"]))
    a5 = a.reshape(*a.shape[:-1], 5, p["B"].shape[1])      # (..., 5, rank)
    lora = torch.einsum("...cr,crd->c...d", a5, p["B"])    # (5, ..., d)
    mix = p["maa"].reshape(5, *([1] * (x.dim() - 1)), x.shape[-1])
    outs = x[None] + dx[None] * (mix + lora)
    return tuple(outs[i] for i in range(5))


def _shifted(h: torch.Tensor) -> torch.Tensor:
    """The previous position's input at every position, zero at the first."""
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def _wkv_chunked(r, k, v, logw, u, s0, chunk: int):
    """Chunked RWKV-6 linear attention through K6.

    r/k/v/logw: (B, H, T, D) fp32; u: (H, D); s0: (B, H, D, D) [key x
    value].  Pads T at the end to a multiple of ``Lc = min(chunk, T)`` —
    exact: k = v = 0 add nothing, logw = 0 (decay 1) leaves the state as it
    is, and the r = 0 rows are sliced away — flattens (B, H), broadcasts
    ``u`` to (B*H, D) and calls :func:`wkv6_chunked`, or, where grad is
    enabled and an operand requires it, :func:`wkv6_scan` (the same K6
    forward, with its gradient; autograd sums ``u``'s over the batch).
    Returns (out (B, H, T, D), s_final (B, H, D, D))."""
    B, H, T, D = r.shape
    Lc = min(chunk, T)
    pad = (-T) % Lc

    def flat(a):
        if pad:
            a = F.pad(a, (0, 0, 0, pad))
        return a.reshape(B * H, T + pad, D).contiguous()

    u_b = u.float()[None].expand(B, H, D).reshape(B * H, D).contiguous()
    grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in (r, k, v, logw, u, s0))
    out, s_fin = (wkv6_scan if grad else wkv6_chunked)(
        flat(r), flat(k), flat(v), flat(logw), u_b,
        s0.reshape(B * H, D, D).contiguous(), chunk=chunk,
    )
    return out.reshape(B, H, T + pad, D)[:, :, :T], s_fin.reshape(B, H, D, D)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel log-decay, fp32, <= 0."""
    return -torch.exp(
        (p["w0"] + torch.matmul(torch.tanh(torch.matmul(xw, p["w1"])),
                                p["w2"])).float()
    )


def apply_rwkv_tm(
    p, h: torch.Tensor, cfg: ModelConfig, rs: RunState, cache: dict | None
) -> tuple[torch.Tensor, dict | None]:
    w = cfg.rwkv
    d = cfg.d_model
    H, D = d // w.head_dim, w.head_dim
    B = h.shape[0]
    zeros_D = torch.zeros((D,), dtype=torch.float32, device=h.device)

    if rs.mode == "decode":
        x = h[:, 0]
        x_prev = cache["tm_x"].to(x.dtype)
        xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
        logw = _decay(p, xw).reshape(B, H, D)
        r_ = torch.matmul(xr, p["wr"]).reshape(B, H, D).float()
        k_ = torch.matmul(xk, p["wk"]).reshape(B, H, D).float()
        v_ = torch.matmul(xv, p["wv"]).reshape(B, H, D).float()
        g_ = F.silu(torch.matmul(xg, p["wg"]))
        s = cache["s"].float()
        kv = k_[..., :, None] * v_[..., None, :]
        u = p["u"].float()[None, :, :, None]
        out = torch.einsum("bhd,bhdv->bhv", r_, s + u * kv)
        s_new = torch.exp(logw)[..., None] * s + kv
        o = L.layer_norm(out, zeros_D).reshape(B, d)
        o = o * p["ln_w"] + p["ln_b"]
        o = torch.matmul(o.to(h.dtype) * g_, p["wo"])
        cache["s"].copy_(s_new)
        cache["tm_x"].copy_(x)
        return o[:, None], cache

    # full mode
    S = h.shape[1]
    x_prev = _shifted(h)
    if cache is not None and not rs.write_cache:
        x_prev[:, 0] = cache["tm_x"].to(h.dtype)
    xw, xk, xv, xr, xg = _ddlerp(p, h, x_prev)
    logw = _decay(p, xw)                                    # (B, S, d), <= 0

    def to_h(t):
        return t.reshape(B, S, H, D).transpose(1, 2).float()

    r_ = to_h(torch.matmul(xr, p["wr"]))
    k_ = to_h(torch.matmul(xk, p["wk"]))
    v_ = to_h(torch.matmul(xv, p["wv"]))
    g_ = F.silu(torch.matmul(xg, p["wg"]))
    s0 = (cache["s"].float() if (cache is not None and not rs.write_cache)
          else torch.zeros((B, H, D, D), dtype=torch.float32, device=h.device))
    out, s_fin = _wkv_chunked(r_, k_, v_, to_h(logw), p["u"], s0, w.chunk)
    o = L.layer_norm(out.transpose(1, 2), zeros_D)          # (B, S, H, D)
    o = o.reshape(B, S, d) * p["ln_w"] + p["ln_b"]
    o = torch.matmul(o.to(h.dtype) * g_, p["wo"])
    new_cache = None
    if cache is not None and rs.write_cache:
        cache["s"].copy_(s_fin)
        cache["tm_x"].copy_(h[:, -1])
        new_cache = cache
    return o, new_cache


def apply_rwkv_cm(
    p, h: torch.Tensor, cfg: ModelConfig, rs: RunState, cache: dict | None
) -> tuple[torch.Tensor, dict | None]:
    if rs.mode == "decode":
        x = h[:, 0]
        x_prev = cache["cm_x"].to(x.dtype)
    else:
        x = h
        x_prev = _shifted(h)
        if cache is not None and not rs.write_cache:
            x_prev[:, 0] = cache["cm_x"].to(h.dtype)
    xk = x + (x_prev - x) * p["maa_k"]
    xr = x + (x_prev - x) * p["maa_r"]
    v = torch.matmul(torch.square(F.relu(torch.matmul(xk, p["wk"]))), p["wv"])
    out = torch.sigmoid(torch.matmul(xr, p["wr"])) * v
    if rs.mode == "decode":
        cache["cm_x"].copy_(x)
        return out[:, None], cache
    if cache is not None and rs.write_cache:
        cache["cm_x"].copy_(h[:, -1])
    return out, cache
