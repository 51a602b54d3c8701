"""Per-layer blocks on PyTorch: the dense global self-attention block.

Ported from ``repro.models.blocks`` (``RunState``, the dense FFN and the
self-attention mixer).  The other layer kinds of the reference (MoE, MLA,
cross-attention, RG-LRU, RWKV, the whisper encoder/decoder layers) belong to
later slices: :func:`repro_torch.models.base.check_supported` refuses their
configs.

Caches differ from the reference in two ways, both because torch updates in
place where JAX returns new arrays:

  * a block **writes its cache tensors in place** (prefill and decode) and
    returns the same dict, so the decode lane's joiner prefills straight
    into its row's slice of the ``(R, ...)`` caches;
  * ``pos`` (absolute position held by each cache slot, -1 = empty) is kept
    per batch row, ``(B, slots)``, so every row of a batched decode step
    masks by its own position ``t[r]``.  The reference keeps one ``(slots,)``
    vector per B-row cache and vmaps over rows to get the same effect.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig, ParamDef
from . import layers as L

__all__ = [
    "RunState", "schema_ffn", "apply_ffn", "schema_attn", "cache_attn",
    "apply_attn",
]


@dataclasses.dataclass
class RunState:
    mode: str                       # "full" | "decode"
    # decode: position being written — an int for the whole batch, or a
    # (B,) tensor of per-row positions (the batched decode lane).
    t: int | torch.Tensor | None = None
    write_cache: bool = False       # prefill: write caches in full mode


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def schema_ffn(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    if cfg.act == "gelu":  # plain (ungated) MLP, whisper-style
        return {"wi_up": ParamDef((d, f)), "wo": ParamDef((f, d))}
    return {
        "wi_gate": ParamDef((d, f)),
        "wi_up": ParamDef((d, f)),
        "wo": ParamDef((f, d)),
    }


def apply_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "gelu":
        h = L.act_fn("gelu")(torch.matmul(x, p["wi_up"]))
        return torch.matmul(h, p["wo"])
    return L.gated_mlp(x, p["wi_gate"], p["wi_up"], p["wo"], cfg.act)


# ---------------------------------------------------------------------------
# Self-attention mixer
# ---------------------------------------------------------------------------


def schema_attn(cfg: ModelConfig) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sch = {
        "wq": ParamDef((d, H, hd)),
        "wk": ParamDef((d, Hkv, hd)),
        "wv": ParamDef((d, Hkv, hd)),
        "wo": ParamDef((H, hd, d), scale=0.02),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamDef((H, hd), init="zeros")
        sch["bk"] = ParamDef((Hkv, hd), init="zeros")
        sch["bv"] = ParamDef((Hkv, hd), init="zeros")
    return sch


def cache_attn(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Global attention: one slot per position up to ``max_len``."""
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": ParamDef((batch, max_len, Hkv, hd), init="zeros"),
        "v": ParamDef((batch, max_len, Hkv, hd), init="zeros"),
        "pos": ParamDef((batch, max_len), init="neg_ones", dtype=torch.int32),
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
    cache: dict | None, *, causal: bool = True,
) -> tuple[torch.Tensor, dict | None]:
    B = h.shape[0]
    q, k, v = _qkv(p, h, cfg)

    if rs.mode == "decode":
        t = _row_positions(rs.t, B, h.device)
        q = L.rope(q, t[:, None], cfg.rope_theta)
        k = L.rope(k, t[:, None], cfg.rope_theta)
        rows = torch.arange(B, device=h.device)
        kc, vc, pos = cache["k"], cache["v"], cache["pos"]
        kc[rows, t] = k[:, 0].to(kc.dtype)
        vc[rows, t] = v[:, 0].to(vc.dtype)
        pos[rows, t] = t.to(pos.dtype)
        # mask by recorded absolute positions, each row at its own t
        valid = (pos >= 0) & (pos <= t[:, None])
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
        o = L.attention(
            q, k, v, causal=causal, logit_cap=cfg.attn_softcap,
            dense_max_seq=cfg.dense_attn_max_seq, block_kv=cfg.flash_block_kv,
            scale=cfg.attn_scale,
        )
        new_cache = None
        if cache is not None and rs.write_cache:
            slots = cache["k"].shape[1]
            if S > slots:
                raise ValueError(
                    f"prefill of {S} positions exceeds the cache's {slots}"
                )
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
            cache["pos"][:, :S] = positions.to(cache["pos"].dtype)
            new_cache = cache

    out = torch.einsum("bshk,hkd->bsd", o.to(h.dtype), p["wo"])
    return out, new_cache
