"""Shared neural layers on PyTorch: norms, RoPE, attention (dense / flash-scan
/ decode), gated MLPs.

Ported from ``repro.models.layers``: pure functions over tensors, with the
reference's layouts (``(B, S, H, hd)`` for attention) and dtype rules
(norms, RoPE angles and softmax in fp32; products in the activation dtype,
attention scores accumulated in fp32).  :func:`attention` dispatches by
sequence length, as the reference does: dense up to ``dense_max_seq ** 2``
score entries, the two-level chunked :func:`flash_attention` above.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm", "layer_norm", "norm", "softcap", "act_fn", "rope",
    "dense_attention", "flash_attention", "decode_attention", "attention",
    "gated_mlp",
]

# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Centered LN with the scale parameterized as ``(1 + w)``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)
            * (1.0 + weight.float())).to(x.dtype)


def norm(x: torch.Tensor, weight: torch.Tensor, kind: str) -> torch.Tensor:
    return rms_norm(x, weight) if kind == "rmsnorm" else layer_norm(x, weight)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def act_fn(kind: str):
    if kind == "swiglu":
        return F.silu
    if kind in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split convention; angles in fp32.

    x: (..., S, H, hd); positions: broadcastable to (..., S).
    """
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
               window: int | None,
               kv_len: torch.Tensor | None) -> torch.Tensor:
    """Additive mask (Sq, Skv) or (B, Sq, Skv); 0 = keep, -inf = drop."""
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= kv_pos[None, :] > (q_pos[:, None] - window)
    if kv_len is not None:
        valid = kv_pos[None, :] < torch.as_tensor(
            kv_len, device=kv_pos.device).reshape(-1, 1)
        ok = ok[None] & valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, float("-inf"))


def dense_attention(
    q: torch.Tensor,               # (B, Sq, Hq, hd)
    k: torch.Tensor,               # (B, Skv, Hkv, hd)
    v: torch.Tensor,               # (B, Skv, Hkv, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_pos: torch.Tensor | None = None,
    kv_pos: torch.Tensor | None = None,
    kv_len: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Unfused attention: full (Sq, Skv) score matrix, fp32 scores and
    softmax, the weights cast to ``v.dtype`` for the value product."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = (hd ** -0.5) if scale is None else scale
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(Skv, device=q.device)

    qg = q.reshape(B, Sq, Hkv, G, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    logits = softcap(logits, logit_cap)
    bias = _mask_bias(q_pos, kv_pos, causal, window, kv_len)
    if bias.dim() == 3:  # (B, Sq, Skv)
        bias = bias[:, None, None]
    w = torch.softmax(logits + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, Hq, hd)


def flash_attention(
    q: torch.Tensor,               # (B, Sq, Hq, hd)
    k: torch.Tensor,               # (B, Skv, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,             # absolute position of q[0] (chunked prefill)
    block_q: int = 512,
    block_kv: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Two-level chunked attention with a running log-sum-exp.

    The reference's blocking: Q in blocks of ``min(block_q, Sq)``, each
    scanning KV in blocks of ``min(block_kv, Skv)`` with a running max
    ``m``, normaliser ``l`` and fp32 accumulator, so the working set is one
    ``(block_q, block_kv)`` score tile per head instead of ``Sq x Skv``.
    Both products return fp32, as the reference's einsums with
    ``preferred_element_type=float32`` do (a bf16 ``torch.einsum`` would
    round the scores and each block's ``p @ v`` to bf16); ``p`` is rounded
    to ``v.dtype`` before its product, as the reference's is.

    A KV block that lies wholly in a causal Q block's future, or wholly
    before the window of the Q block's first position, is skipped: under
    the reference's mask it contributes exactly zero (``p = 0``, the
    correction exactly 1, or 0 on a row still fully masked).  Nothing else
    departs from the reference's arithmetic.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = (hd ** -0.5) if scale is None else scale
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv)
    if Sq % block_q or Skv % block_kv:
        raise AssertionError((Sq, block_q, Skv, block_kv))
    nq, nk = Sq // block_q, Skv // block_kv

    # (B, Hkv, G, S, hd) / (B, Hkv, 1, S, hd): each block a matmul operand.
    qh = q.reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4).float().contiguous()
    kh = k.permute(0, 2, 1, 3)[:, :, None].float().contiguous()
    vh = v.permute(0, 2, 1, 3)[:, :, None].float().contiguous()
    out = torch.empty((B, Hkv, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    ar_q = torch.arange(block_q, device=q.device)
    ar_kv = torch.arange(block_kv, device=q.device)
    for qi in range(nq):
        q0 = q_offset + qi * block_q
        q_pos = q0 + ar_q
        qblk = qh[:, :, :, qi * block_q : (qi + 1) * block_q]
        acc = torch.zeros((B, Hkv, G, block_q, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, Hkv, G, block_q), float("-inf"),
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        for ki in range(nk):
            if causal and ki * block_kv > q0 + block_q - 1:
                break                # this block and the rest: all future
            if window is not None and (ki + 1) * block_kv <= q0 - window + 1:
                continue             # all before every row's window
            kv = slice(ki * block_kv, (ki + 1) * block_kv)
            kv_pos = ki * block_kv + ar_kv
            s = torch.matmul(qblk, kh[:, :, :, kv].transpose(-1, -2)) * scale
            s = softcap(s, logit_cap)
            ok = torch.ones((block_q, block_kv), dtype=torch.bool,
                            device=q.device)
            if causal:
                ok &= kv_pos[None, :] <= q_pos[:, None]
            if window is not None:
                ok &= kv_pos[None, :] > (q_pos[:, None] - window)
            s = s.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # fully masked rows keep m = -inf; exp(-inf - -inf) needs a safe m
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.where(torch.isinf(m), float("-inf"),
                                         m - m_safe))
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(p.to(v.dtype).float(), vh[:, :, :, kv])
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, :, qi * block_q : (qi + 1) * block_q] = (
            acc / torch.clamp_min(l, 1e-30)[..., None]
        )
    # (B, Hkv, G, Sq, hd) -> (B, Sq, Hq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def decode_attention(
    q: torch.Tensor,               # (B, 1, Hq, hd)
    k_cache: torch.Tensor,         # (B, Smax, Hkv, hd)
    v_cache: torch.Tensor,
    t,                             # position written this step: int or (B,)
    *,
    window: int | None = None,
    logit_cap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token attention against a KV cache; positions ``0..t`` are
    valid.  ``t`` may differ per batch row (the reference's scalar ``t``
    broadcast, or the batched decode lane's per-row positions)."""
    B, _, Hq, hd = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = (hd ** -0.5) if scale is None else scale
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    s = softcap(s, logit_cap)
    kv_pos = torch.arange(Smax, device=q.device)
    t = torch.as_tensor(t, device=q.device).reshape(-1, 1)
    ok = kv_pos[None] <= t           # (B or 1, Smax)
    if window is not None:
        ok &= kv_pos[None] > (t - window)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v_cache)
    return out.reshape(B, 1, Hq, hd)


def attention(q, k, v, *, causal=True, window=None, logit_cap=None,
              q_offset=0, dense_max_seq=1024, block_kv=1024, scale=None):
    """Dispatch dense vs flash-scan by sequence length."""
    if q.shape[1] * k.shape[1] <= dense_max_seq * dense_max_seq:
        return dense_attention(
            q, k, v, causal=causal, window=window, logit_cap=logit_cap,
            q_pos=q_offset + torch.arange(q.shape[1], device=q.device),
            kv_pos=torch.arange(k.shape[1], device=q.device), scale=scale,
        )
    return flash_attention(
        q, k, v, causal=causal, window=window, logit_cap=logit_cap,
        q_offset=q_offset, block_kv=block_kv, scale=scale,
    )


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gated_mlp(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
              wo: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU / GeGLU: act(x @ wi_gate) * (x @ wi_up) @ wo."""
    g = act_fn(act)(torch.matmul(x, wi_gate))
    u = torch.matmul(x, wi_up)
    return torch.matmul(g * u, wo)
