"""Model API on PyTorch — what the serving steps and the decode lane use.

Ported from ``repro.models.api`` for token LMs (attention stacks:
global, sliding-window and MLA mixers with dense or MoE FFNs;
RecurrentGemma's RG-LRU / local-attention hybrid; RWKV-6 stacks),
vision-language stacks whose cross layers attend to a patch stream, and
Whisper's audio encoder-decoder (:mod:`repro_torch.models.whisper`).
``Model(cfg, device)`` exposes:

  schema() / init(generator) / param_count()
                                      — parameters as a :class:`ParamTree`
  axes() / abstract_params()          — each leaf's logical axes, and its
                                        shape on the ``meta`` device
  loss(params, batch, remat)          — next-token CE (mean over tokens)
  logits(params, batch, remat)        — full-sequence logits
  cache_schema(batch, max_len) / init_cache(batch, max_len)
  prefill(params, batch, max_len)     — (last-position logits, caches)
  prefill_with_cache(params, batch, caches)
  decode(params, token, t, caches)    — one-token step

Batches are dicts of ``{"tokens": (B, S), "targets": (B, S)}`` integer
tensors, and for a vlm ``"patches": (B, n_tokens, d_in)`` (the stubbed
vision tower's output, fp32), for an audio model ``"frames": (B,
n_frames, d_in)`` (the stubbed conv frontend's output, fp32).  An audio
model's parameters are ``{enc_proj, enc_blocks, enc_norm, dec}`` and its
caches ``{"dec": ...}``; its decoder, ``params["dec"]``, is the stack the
token steps run.  :func:`params_from_jax` carries a reference parameter tree
(as numpy arrays) over into the port, so both packages compute with the
same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .base import (ModelConfig, ParamTree, abstract_params, check_supported,
                   init_params, param_axes)
from . import blocks as B
from . import stack as S
from . import whisper as W

__all__ = ["Model", "cross_entropy", "params_from_jax"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token CE; logits fp32 (B, S, V), targets (B, S) int."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - picked)


class Model:
    """A token LM on one device: the card unless the caller names
    another (``device="cpu"``); raises when CUDA is asked for and absent."""

    def __init__(self, cfg: ModelConfig, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def _audio(self) -> bool:
        return self.cfg.family == "audio"

    # -- params ------------------------------------------------------------
    def schema(self) -> dict:
        if self._audio:
            return W.whisper_schema(self.cfg)
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

    def param_count(self) -> int:
        """Parameters in the schema, counted without allocating any."""
        return self.cfg.param_count()

    def axes(self) -> dict:
        """Every parameter's logical axes, nested as the parameters are."""
        return param_axes(self.schema())

    def abstract_params(self) -> dict:
        """Every parameter as a ``meta`` tensor (its shape and dtype, no
        storage), nested as the parameters are."""
        return abstract_params(self.schema(), self.cfg.pdtype)

    # -- caches ------------------------------------------------------------
    def cache_schema(self, batch: int, max_len: int) -> dict:
        if self._audio:
            return W.whisper_cache_schema(self.cfg, batch, max_len)
        return S.model_cache_schema(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_params(
            self.cache_schema(batch, max_len), self.cfg.adtype, None,
            self.device,
        )

    # -- compute -----------------------------------------------------------
    def _trunk(self, params, batch: dict, remat: bool = False):
        """``(stack params, cross context at d_model or None)``: an audio
        model's decoder and its frames through the encoder; a vlm's params
        and its patches through ``frontend_proj``; else the params and
        None."""
        if self._audio:
            return params["dec"], W.encode(params, batch["frames"], self.cfg,
                                           remat=remat)
        if self.cfg.family == "vlm":
            return params, S.project_ctx(params, self.cfg, batch["patches"])
        return params, None

    def logits(self, params, batch: dict, remat: bool = False) -> torch.Tensor:
        p, ctx = self._trunk(params, batch, remat)
        lg, _ = S.forward(p, self.cfg, batch["tokens"], remat=remat, ctx=ctx)
        return lg

    def loss(self, params, batch: dict, remat: bool = False) -> torch.Tensor:
        """Mean next-token cross-entropy: the chunked
        :func:`~repro_torch.models.stack.fused_ce` when ``cfg.fused_ce``,
        else :func:`cross_entropy` of the full logits."""
        if self.cfg.fused_ce:
            p, ctx = self._trunk(params, batch, remat)
            h = S.hidden_states(p, self.cfg, batch["tokens"], ctx=ctx,
                                remat=remat)
            return S.fused_ce(p, self.cfg, h, batch["targets"])
        return cross_entropy(self.logits(params, batch, remat=remat),
                             batch["targets"])

    def prefill(self, params, batch: dict, max_len: int):
        caches = self.init_cache(batch["tokens"].shape[0], max_len)
        return self.prefill_with_cache(params, batch, caches)

    def prefill_with_cache(self, params, batch: dict, caches):
        """Prefill into caller-provided caches (written in place); returns
        the last position's logits (B, 1, V).  Only that position goes
        through the LM head (the reference computes every position's logits
        and keeps the last: (B, S, V) fp32 is 50 GB for 8 prompts of 6144
        at vocab 256000).  An audio model's frames go through the encoder
        once; each ``dec`` layer keeps their K/V in its cross cache."""
        p, ctx = self._trunk(params, batch)
        rs = B.RunState(mode="full", write_cache=True, ctx=ctx)
        h = S.embed_tokens(p, batch["tokens"], self.cfg)
        h, new = S.apply_stack(p, h, self.cfg, rs,
                               caches["dec"] if self._audio else caches)
        logits = S.lm_head(p, h[:, -1:], self.cfg)
        return logits, ({"dec": new} if self._audio else new)

    def decode(self, params, token: torch.Tensor, t, caches):
        if self._audio:
            return W.decode_step(params, self.cfg, token, t, caches)
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

    The reference keeps its unscanned layers in ``tree["prefix"]`` /
    ``tree["suffix"]`` (lists) and its scanned group as one dict per
    position of the block pattern, ``tree["blocks"][f"b{i}"]``, each leaf
    stacked on a leading ``n_groups`` axis.  The port keeps one dict per
    layer in ``cfg.layer_kinds()`` order: the prefix layers, then layer
    ``g * P + i`` of the scanned part (pattern of P kinds) takes slice ``g``
    of every leaf of ``b{i}`` (an rwkv block's ``(5, d)`` / ``(5, rank,
    d)`` token-shift mixes and its ``(H, hd)`` bonus ``u`` included), then
    the suffix layers.  Nested leaves carry over by name: an MoE FFN's
    ``router`` / ``wg`` / ``wu`` / ``wd`` and its ``shared`` FFN, MLA's
    seven weights, an RG-LRU mixer's ten (``w_y``, ``w_x``, ``conv_w``,
    ``conv_b``, the block-diagonal gates ``gate_a`` / ``gate_x`` and their
    biases, ``lam``, ``w_out``), a cross layer's ``wq`` / ``wk`` / ``wv`` /
    ``wo``, ``ctx_norm`` and its two gates (slice ``g`` of a ``(n_groups,)``
    leaf is the 0-d gate of group ``g``); a vlm's ``frontend_proj`` is a
    top-level leaf.

    An audio model's tree nests: ``enc_proj`` and ``enc_norm`` are
    top-level leaves, ``enc_blocks["b0"]`` (stacked on ``enc_layers``)
    becomes the list ``enc_blocks`` of per-layer dicts, and ``dec`` (the
    decoder, a ``dec`` layer's ``norm_cross`` and ``cross`` among its
    leaves) takes the layout above.
    """
    check_supported(cfg)

    def conv(node, index=None):
        if isinstance(node, dict):
            return {k: conv(v, index) for k, v in node.items()}
        a = np.asarray(node)
        return _tensor(a if index is None else a[index], device)

    def stack_tree(tree):
        layers = ("prefix", "blocks", "suffix")
        out = {k: conv(v) for k, v in tree.items() if k not in layers}
        P = len(cfg.block_pattern)
        out["blocks"] = (
            [conv(p) for p in tree.get("prefix", [])]
            + [conv(tree["blocks"][f"b{i}"], g)
               for g in range(cfg.n_groups) for i in range(P)]
            + [conv(p) for p in tree.get("suffix", [])]
        )
        return out

    if cfg.family != "audio":
        return ParamTree(stack_tree(tree))
    return ParamTree({
        "enc_proj": conv(tree["enc_proj"]),
        "enc_blocks": [conv(tree["enc_blocks"]["b0"], i)
                       for i in range(cfg.frontend.enc_layers)],
        "enc_norm": conv(tree["enc_norm"]),
        "dec": stack_tree(tree["dec"]),
    })
