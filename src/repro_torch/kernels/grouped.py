"""Slot-indexed grouped GEMMs for the delivery engine and decode, on Hopper.

The engine's microbatch carries a ``(G,)`` vector of *slot indices* into the
stacked per-tenant secrets (``cores (S, q, q)``, ``c_acs (S, K, N)``).  The
wrappers launch slot-indexed entry points of hand-written CUDA kernels
(bound in :mod:`.gemm`), which read each group's slot straight out of the
stack (no ``(G, ...)`` gather copy), for any index vector and any shape:

  * :func:`grouped_block_diag_matmul` (K1) replaces the Pallas kernel of the
    same name (``repro/kernels/grouped.py``): ``x`` viewed as
    ``(G, B*kappa, q)`` times the slot's core, through the split-K morph
    kernel in ``csrc/morph_gemm.cu`` (``morph_sgemm``; the split is
    :func:`.gemm.morph_splits` of the shape and the card's SMs);
  * :func:`grouped_aug_gemm` (K2) replaces ``grouped_aug_gemm``: ``t[g]``
    times the slot's Aug-Conv matrix, in split TF32 on the tensor cores,
    through ``csrc/aug_gemm.cu`` (``aug_sgemm_grouped``);
  * :func:`grouped_row_gemm` (K3) replaces ``grouped_row_gemm``, the logits
    step of batched decode: ``h[r]`` times its slot's fused LM head (fp32
    or bf16 stacks), through the decode-shaped kernel in
    ``csrc/row_gemm.cu`` (its split of the work is
    :func:`.gemm.row_splits`).

Each of these CUDA sources also has an entry point with a null slot-index
pointer (slot = group index): ``morph_gemm_typed`` serves K4
(:mod:`.block_diag`), ``aug_gemm_typed`` K5 (:mod:`.aug_gemm`).

The device of the tensors picks the implementation: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version in ``ref.py``.
There is no other switch.  Each wrapper counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from . import gemm, ref

__all__ = ["grouped_block_diag_matmul", "grouped_aug_gemm", "grouped_row_gemm"]


def _check(name: str, a: torch.Tensor, gidx: torch.Tensor,
           b: torch.Tensor) -> None:
    """What the kernel takes: one device, fp32 operands, int32 gidx (G,),
    contiguous, non-empty, within the grid limits (:func:`gemm.check_operands`)."""
    gemm.refuse_dtensor(name, a, gidx, b)
    if gidx.device != a.device:
        raise ValueError(
            f"{name}: operands on different devices "
            f"({a.device}, {gidx.device}, {b.device})"
        )
    gemm.check_operands(name, a, b, (torch.float32,))
    if gidx.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 gidx, got {gidx.dtype}")
    if a.dim() != 3 or b.dim() != 3 or gidx.shape != (a.shape[0],):
        raise ValueError(
            f"{name}: expected (G, B, F), (G,), (S, ., .); got "
            f"{tuple(a.shape)}, {tuple(gidx.shape)}, {tuple(b.shape)}"
        )
    if not gidx.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")


def grouped_block_diag_matmul(
    x: torch.Tensor,        # (G, B, F) with F = kappa * q
    gidx: torch.Tensor,     # (G,) int32 slot index per group
    cores: torch.Tensor,    # (S, q, q) stacked per-slot morph cores
    kappa: int,
) -> torch.Tensor:
    """Per-group repeated-block-diagonal morph, secrets read in place.

    ``y[g] = reshape(x[g], (B, kappa, q)) @ cores[gidx[g]]``.
    """
    _check("grouped_block_diag_matmul", x, gidx, cores)
    G, B, F = x.shape
    q = cores.shape[-1]
    if cores.shape[1] != q or F != kappa * q:
        raise ValueError(
            f"grouped_block_diag_matmul: x {tuple(x.shape)} is not kappa={kappa} "
            f"blocks of the cores {tuple(cores.shape)}"
        )
    if x.device.type == "cpu":
        return ref.block_diag_matmul_grouped_ref(x, gidx, cores, kappa)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_block_diag_matmul: no kernel for {x.device}")
    out = gemm.morph("grouped_block_diag_matmul", x.view(G, B * kappa, q),
                     gidx, cores)
    grouped_block_diag_matmul.launches += 1
    return out.view_as(x)


def grouped_aug_gemm(
    t: torch.Tensor,        # (G, B, K) morphed rows
    gidx: torch.Tensor,     # (G,) int32 slot index per group
    c_acs: torch.Tensor,    # (S, K, N) stacked per-slot Aug-Conv matrices
) -> torch.Tensor:
    """Per-group Aug-Conv forward ``t[g] @ c_acs[gidx[g]]``, secrets in place."""
    _check("grouped_aug_gemm", t, gidx, c_acs)
    G, B, K = t.shape
    N = c_acs.shape[-1]
    if c_acs.shape[1] != K:
        raise ValueError(
            f"grouped_aug_gemm: t {tuple(t.shape)} does not match c_acs "
            f"{tuple(c_acs.shape)}"
        )
    if t.device.type == "cpu":
        return ref.aug_gemm_grouped_ref(t, gidx, c_acs)
    if t.device.type != "cuda":
        raise ValueError(f"grouped_aug_gemm: no kernel for {t.device}")
    out = gemm.aug("grouped_aug_gemm", t, gidx, c_acs)
    grouped_aug_gemm.launches += 1
    return out


def grouped_row_gemm(
    h: torch.Tensor,        # (R, K) fp32 or bf16, one decode row per group
    gidx: torch.Tensor,     # (R,) int32 slot index per row
    tables: torch.Tensor,   # (S, K, N) fp32 or bf16 stacked per-slot matrices
) -> torch.Tensor:
    """Decode-shaped grouped GEMM ``h[r] @ tables[gidx[r]]`` -> (R, N).

    Contracts in ``h.dtype``: each table entry is rounded to ``h.dtype``
    before the product, the sum is accumulated in fp32, and the result is
    ``h.dtype`` — the semantics of the reference's jnp path and of
    ``models.stack.lm_head``.  Tables may be fp32 or bf16 with either h: a
    bf16 entry is exact in fp32, so bf16 tables give the logits that fp32
    tables holding the same (bf16-representable) values give, from half
    the bytes; the decode lane stages its head stacks so in bf16 models.
    """
    name = "grouped_row_gemm"
    gemm.refuse_dtensor(name, h, gidx, tables)
    if not (h.device == gidx.device == tables.device):
        raise ValueError(
            f"{name}: operands on different devices "
            f"({h.device}, {gidx.device}, {tables.device})"
        )
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: h must be float32 or bfloat16, got {h.dtype}")
    if tables.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"{name}: expected float32 or bfloat16 tables, got {tables.dtype}"
        )
    if gidx.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 gidx, got {gidx.dtype}")
    if (h.dim() != 2 or tables.dim() != 3 or gidx.shape != (h.shape[0],)
            or tables.shape[1] != h.shape[1]):
        raise ValueError(
            f"{name}: expected (R, K), (R,), (S, K, N); got "
            f"{tuple(h.shape)}, {tuple(gidx.shape)}, {tuple(tables.shape)}"
        )
    if not (h.is_contiguous() and gidx.is_contiguous()
            and tables.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if min(h.shape) == 0 or min(tables.shape) == 0:
        raise ValueError(
            f"{name}: empty operand {tuple(h.shape)}, {tuple(tables.shape)}"
        )
    if h.shape[0] > gemm.MAX_GRID_YZ:
        raise ValueError(f"{name}: {h.shape[0]} rows exceed the grid limit")
    if h.device.type == "cpu":
        return ref.lm_head_rows_grouped_ref(h, gidx, tables)
    if h.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {h.device}")
    out = gemm.rows(name, h, gidx, tables)
    grouped_row_gemm.launches += 1
    return out


grouped_block_diag_matmul.launches = 0
grouped_aug_gemm.launches = 0
grouped_row_gemm.launches = 0
