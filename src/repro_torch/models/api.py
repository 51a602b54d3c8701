"""Model API on PyTorch — what the serving steps and the decode lane use.

Ported from ``repro.models.api`` for plain token LMs (dense global
attention and RWKV-6 stacks).  ``Model(cfg,
device)`` exposes:

  schema() / init(generator)          — parameters as a :class:`ParamTree`
  cache_schema(batch, max_len) / init_cache(batch, max_len)
  prefill(params, batch, max_len)     — (last-position logits, caches)
  prefill_with_cache(params, batch, caches)
  decode(params, token, t, caches)    — one-token step

``logits``/``loss`` (training) arrive with a later slice.
:func:`params_from_jax` carries a reference parameter tree (as numpy
arrays) over into the port, so both packages compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .base import ModelConfig, ParamTree, check_supported, init_params
from . import stack as S

__all__ = ["Model", "params_from_jax"]


class Model:
    """A token LM on one device: the card unless the caller names
    another (``device="cpu"``); raises when CUDA is asked for and absent."""

    def __init__(self, cfg: ModelConfig, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- params ------------------------------------------------------------
    def schema(self) -> dict:
        return S.model_schema(self.cfg)

    def init(self, generator: torch.Generator | int) -> ParamTree:
        """Random parameters from ``generator`` (or a seed for a fresh
        generator on this model's device), drawn on the device."""
        if isinstance(generator, int):
            generator = torch.Generator(device=self.device).manual_seed(
                generator
            )
        return ParamTree(init_params(
            self.schema(), self.cfg.pdtype, generator, self.device
        ))

    # -- caches ------------------------------------------------------------
    def cache_schema(self, batch: int, max_len: int) -> dict:
        return S.model_cache_schema(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_params(
            self.cache_schema(batch, max_len), self.cfg.adtype, None,
            self.device,
        )

    # -- compute -----------------------------------------------------------
    def prefill(self, params, batch: dict, max_len: int):
        caches = self.init_cache(batch["tokens"].shape[0], max_len)
        return self.prefill_with_cache(params, batch, caches)

    def prefill_with_cache(self, params, batch: dict, caches):
        """Prefill into caller-provided caches (written in place)."""
        lg, caches = S.forward(
            params, self.cfg, batch["tokens"], caches=caches, write_cache=True
        )
        return lg[:, -1:], caches

    def decode(self, params, token: torch.Tensor, t, caches):
        return S.decode_step(params, self.cfg, token, t, caches)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: exact via fp32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16
        )
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: dict, cfg: ModelConfig, device) -> ParamTree:
    """The reference's parameter tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's :class:`ParamTree`
    on ``device`` (no default: the caller says where the weights live).

    The reference stacks the scanned block group's leaves on a leading
    ``n_groups`` axis (``tree["blocks"]["b0"]``); the port keeps one dict
    per layer, so layer ``i`` takes slice ``i`` of every stacked leaf (an
    rwkv block's ``(5, d)`` / ``(5, rank, d)`` token-shift mixes and its
    ``(H, hd)`` bonus ``u`` included).
    """
    check_supported(cfg)

    def conv(node, index=None):
        if isinstance(node, dict):
            return {k: conv(v, index) for k, v in node.items()}
        a = np.asarray(node)
        return _tensor(a if index is None else a[index], device)

    out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [conv(tree["blocks"]["b0"], i)
                     for i in range(cfg.n_groups)]
    return ParamTree(out)
