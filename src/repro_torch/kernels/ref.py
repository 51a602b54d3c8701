"""Plain PyTorch versions of the port's CUDA kernels and of the LM gathers.

The CPU path of every kernel wrapper (:mod:`.grouped`, :mod:`.block_diag`,
:mod:`.aug_gemm`), and the versions ``chip_smoke.py`` holds the kernels
against on the card.  They repeat the reference's math
(``repro.kernels.ref``): the morph and Aug-Conv GEMMs cast operands to fp32,
compute, and round once back to the input dtype; the LM-head GEMMs
contract in ``h.dtype`` (the weights cast to it), as ``models.stack.lm_head``
does.  Grouped versions take the slot-index vector and the stacked
``(S, ...)`` secrets and index one slot per group or row (a view or an
advanced-indexing gather, never a ``(G, ...)`` copy of the stack); slot
indices clamp into ``[0, S-1]`` as the kernels clamp them.

The token-morph and Aug-Embedding functions are gathers; they have no CUDA
kernel (the reference routes them to XLA's gather on every backend too), so
these are also their implementations on the card.

The RWKV-6 scan has two plain versions: :func:`wkv6_ref`, the token-by-token
recurrence (the semantic oracle, ``repro.kernels.ref.wkv6_ref``), and
:func:`wkv6_chunked_ref`, the chunked form with the Pallas kernel's
``(BH, T, D)`` signature (``repro.kernels.wkv6.wkv6_chunked``), which is
the CPU path of :func:`repro_torch.kernels.wkv6.wkv6_chunked`.
:func:`wkv6_rows_ref` is the key-row scan of the scan's gradient, the CPU
path of :func:`repro_torch.kernels.wkv6.wkv6_rows`.
"""
from __future__ import annotations

import torch

__all__ = [
    "block_diag_matmul_ref",
    "aug_gemm_ref",
    "block_diag_matmul_batched_ref",
    "aug_gemm_batched_ref",
    "block_diag_matmul_grouped_ref",
    "aug_gemm_grouped_ref",
    "token_morph_batched_ref",
    "token_morph_grouped_ref",
    "aug_embed_batched_ref",
    "aug_embed_grouped_ref",
    "aug_embed_rows_batched_ref",
    "aug_embed_rows_grouped_ref",
    "lm_head_rows_grouped_ref",
    "lm_head_rows_batched_ref",
    "wkv6_ref",
    "wkv6_chunked_ref",
    "wkv6_rows_ref",
]


def block_diag_matmul_ref(x: torch.Tensor, core: torch.Tensor,
                          kappa: int) -> torch.Tensor:
    """y = x @ blockdiag(core x kappa);  x: (R, kappa*q), core: (q, q)."""
    R, F = x.shape
    q = core.shape[0]
    blocks = x.reshape(R, kappa, q).float()
    out = torch.matmul(blocks, core.float())
    return out.reshape(R, F).to(x.dtype)


def aug_gemm_ref(t: torch.Tensor, c_ac: torch.Tensor) -> torch.Tensor:
    """t (B, K) @ c_ac (K, N) in fp32."""
    return torch.matmul(t.float(), c_ac.float()).to(t.dtype)


def block_diag_matmul_batched_ref(x: torch.Tensor, cores: torch.Tensor,
                                  kappa: int) -> torch.Tensor:
    """Per-group morphing, one core per group: x (G, B, kappa*q), cores
    (G, q, q) -> (G, B, kappa*q)."""
    G, B, F = x.shape
    q = cores.shape[-1]
    blocks = x.reshape(G, B * kappa, q).float()
    out = torch.bmm(blocks, cores.float())
    return out.reshape(G, B, F).to(x.dtype)


def aug_gemm_batched_ref(t: torch.Tensor, c_acs: torch.Tensor) -> torch.Tensor:
    """Per-group Aug-Conv forward: t (G, B, K) @ c_acs (G, K, N) -> (G, B, N)
    in fp32."""
    return torch.bmm(t.float(), c_acs.float()).to(t.dtype)


def _slots(gidx: torch.Tensor, n_slots: int) -> list[int]:
    return [min(max(int(i), 0), n_slots - 1) for i in gidx.tolist()]


def _clamped(gidx: torch.Tensor, n_slots: int) -> torch.Tensor:
    return gidx.to(torch.int64).clamp(0, n_slots - 1)


def block_diag_matmul_grouped_ref(
    x: torch.Tensor, gidx: torch.Tensor, cores: torch.Tensor, kappa: int
) -> torch.Tensor:
    """Slot-indexed morphing: x (G, B, kappa*q), gidx (G,), cores (S, q, q)."""
    return torch.stack([
        block_diag_matmul_ref(x[g], cores[s], kappa)
        for g, s in enumerate(_slots(gidx, cores.shape[0]))
    ])


def aug_gemm_grouped_ref(
    t: torch.Tensor, gidx: torch.Tensor, c_acs: torch.Tensor
) -> torch.Tensor:
    """Slot-indexed Aug-Conv forward: t (G, B, K), gidx (G,), c_acs (S, K, N)."""
    return torch.stack([
        aug_gemm_ref(t[g], c_acs[s])
        for g, s in enumerate(_slots(gidx, c_acs.shape[0]))
    ])


def token_morph_batched_ref(tokens: torch.Tensor,
                            perms: torch.Tensor) -> torch.Tensor:
    """Per-group token morphing: tokens (G, B, L), perms (G, V) -> (G, B, L)."""
    g = torch.arange(tokens.shape[0], device=tokens.device)
    return perms[g[:, None, None], tokens.long()]


def token_morph_grouped_ref(tokens: torch.Tensor, gidx: torch.Tensor,
                            perms: torch.Tensor) -> torch.Tensor:
    """Slot-indexed token morphing: tokens (G, B, L), gidx (G,), perms (S, V)."""
    g = _clamped(gidx, perms.shape[0])
    return perms[g[:, None, None], tokens.long()]


def aug_embed_batched_ref(tokens: torch.Tensor,
                          tables: torch.Tensor) -> torch.Tensor:
    """Per-group Aug-Embedding: tokens (G, B, L), tables (G, V, d)
    -> (G, B, L, d)."""
    g = torch.arange(tokens.shape[0], device=tokens.device)
    return tables[g[:, None, None], tokens.long()]


def aug_embed_grouped_ref(tokens: torch.Tensor, gidx: torch.Tensor,
                          tables: torch.Tensor) -> torch.Tensor:
    """Slot-indexed Aug-Embedding: tokens (G, B, L), gidx (G,),
    tables (S, V, d) -> (G, B, L, d)."""
    g = _clamped(gidx, tables.shape[0])
    return tables[g[:, None, None], tokens.long()]


def aug_embed_rows_batched_ref(tokens: torch.Tensor,
                               tables: torch.Tensor) -> torch.Tensor:
    """Per-row AugE gather, one table per row: tokens (R,), tables
    (R, V, d) -> (R, d)."""
    r = torch.arange(tokens.shape[0], device=tokens.device)
    return tables[r, tokens.long()]


def aug_embed_rows_grouped_ref(tokens: torch.Tensor, gidx: torch.Tensor,
                               tables: torch.Tensor) -> torch.Tensor:
    """Per-row slot-indexed AugE gather (batched decode: one token per row):
    tokens (R,), gidx (R,), tables (S, V, d) -> (R, d)."""
    return tables[_clamped(gidx, tables.shape[0]), tokens.long()]


def lm_head_rows_grouped_ref(h: torch.Tensor, gidx: torch.Tensor,
                             heads: torch.Tensor) -> torch.Tensor:
    """Per-row slot-indexed LM-head GEMM: h (R, d), gidx (R,), heads
    (S, d, V) -> (R, V) in ``h.dtype``; each row contracts against its
    slot's head cast to ``h.dtype`` (fp32 accumulation on the card)."""
    return torch.cat([
        torch.matmul(h[r : r + 1], heads[s].to(h.dtype))
        for r, s in enumerate(_slots(gidx, heads.shape[0]))
    ])


def lm_head_rows_batched_ref(h: torch.Tensor,
                             heads: torch.Tensor) -> torch.Tensor:
    """Per-row LM-head GEMM, one head per row: h (R, d), heads (R, d, V)
    -> (R, V), contraction in ``h.dtype``."""
    return torch.bmm(h[:, None, :], heads.to(h.dtype))[:, 0]


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """Naive token-by-token RWKV-6 recurrence (the semantic oracle), in
    fp32.  r/k/v/logw: (B, H, T, D); u: (H, D); s0: (B, H, D, D).

      out_t = r_t (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T

    Returns (out (B, H, T, D), s_final (B, H, D, D))."""
    r, k, v, logw = (a.float() for a in (r, k, v, logw))
    u = u.float()[None, :, :, None]
    s = s0.float()
    outs = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhd,bhdv->bhv", r[:, :, t], s + u * kv))
        s = torch.exp(logw[:, :, t])[..., None] * s + kv
    return torch.stack(outs, dim=2), s


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                     *, chunk: int):
    """The chunked RWKV-6 scan in plain PyTorch, with the explicit (L, L, D)
    decay tensor of each chunk (the reference's 3-tensor form).

    r/k/v/logw: (BH, T, D) with logw <= 0; u: (BH, D); s0: (BH, D, D).
    ``T`` must be a multiple of ``L = min(chunk, T)``.  Computes in fp32;
    returns (out (BH, T, D) in ``r.dtype``, s_final (BH, D, D) fp32).
    Every exponent is <= 0."""
    BH, T, D = r.shape
    L = min(chunk, T)
    assert T % L == 0, (T, L)
    n = T // L
    rc, kc, vc, lw = (a.float().reshape(BH, n, L, D) for a in (r, k, v, logw))
    u = u.float()[:, None, :]
    s = s0.float()
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    outs = []
    for c in range(n):
        rn, kn, vn, lwn = rc[:, c], kc[:, c], vc[:, c], lw[:, c]
        clw = torch.cumsum(lwn, dim=1)           # inclusive
        clw_prev = clw - lwn                     # exclusive
        out = torch.bmm(rn * torch.exp(clw_prev), s)
        diff = clw_prev[:, :, None, :] - clw[:, None, :, :]      # (BH, t, s, D)
        diff = diff.masked_fill(~tri[None, :, :, None], float("-inf"))
        scores = torch.einsum("btd,bsd,btsd->bts", rn, kn, torch.exp(diff))
        out = out + torch.bmm(scores, vn)
        out = out + (rn * u * kn).sum(-1, keepdim=True) * vn
        last = clw[:, -1]                        # (BH, D)
        k_dec = kn * torch.exp(last[:, None, :] - clw)
        s = torch.exp(last)[:, :, None] * s + torch.bmm(k_dec.transpose(1, 2), vn)
        outs.append(out)
    return torch.cat(outs, dim=1).to(r.dtype), s


def wkv6_rows_ref(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                  logw: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """The key-row scan, token by token in fp32: x/y/z/logw (BH, T, D),
    s0 (BH, D, D).  From M = s0, at each token

      out_t[i] = M[i, :] . z_t;  then  M[i, :] = e^{logw_t[i]} M[i, :] + x_t[i] y_t

    Returns out (BH, T, D) fp32."""
    x, y, z, w = (a.float() for a in (x, y, z, torch.exp(logw.float())))
    m = s0.float()
    outs = []
    for t in range(x.shape[1]):
        outs.append(torch.bmm(m, z[:, t, :, None])[..., 0])
        m = torch.addcmul(w[:, t, :, None] * m, x[:, t, :, None], y[:, t, None, :])
    return torch.stack(outs, dim=1)
