"""VGG-style CNN for the paper's own experiment (§4.4), on PyTorch: CIFAR
classification with the first conv layer optionally replaced by a fixed
Aug-Conv matrix.

Port of ``repro.models.cnn``.  The experiment's groups: (1) baseline, VGG on
the original images; (2) MoLe, the first layer is the fixed ``C^{ac}``
applied to *morphed* rows; (3) no Aug-Conv, an unmodified VGG fed the
morphed rows (accuracy collapses).  With the secret channel permutation
absorbed into ``convs[0].b`` and ``convs[1].w``, group 2 computes group 1's
function exactly (paper eq. 5), in training as in inference.

Parameters are the reference's tree, ``{"convs": [{"w", "b"}, ...], "head":
{"w", "b"}}``, with ``w`` in OIHW and the head as ``(features, classes)``;
activations are NCHW and flattened in that order before the head, so
:func:`params_from_jax` carries the reference's weights over unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.d2r import ConvGeometry, reroll_batch
from ..device import resolve_device
from ..kernels.ops import aug_conv_forward

__all__ = [
    "VGGConfig", "vgg16", "vgg_small", "init", "first_layer_kernels",
    "apply", "params_from_jax", "VGG",
]


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    in_channels: int = 3
    image_size: int = 32
    # channel widths per stage; each stage = len(widths[i]) convs + maxpool
    stages: tuple[tuple[int, ...], ...] = ((64, 64), (128, 128), (256, 256, 256),
                                           (512, 512, 512), (512, 512, 512))
    classes: int = 10
    kernel: int = 3

    @property
    def first_geom(self) -> ConvGeometry:
        return ConvGeometry(
            alpha=self.in_channels, beta=self.stages[0][0],
            m=self.image_size, p=self.kernel,
        )

    def conv_shapes(self) -> list[tuple[int, int]]:
        c_in = self.in_channels
        out = []
        for stage in self.stages:
            for c_out in stage:
                out.append((c_in, c_out))
                c_in = c_out
        return out


def vgg16() -> VGGConfig:
    return VGGConfig()


def vgg_small() -> VGGConfig:
    """Reduced config for CPU-scale experiments."""
    return VGGConfig(stages=((16, 16), (32, 32), (64, 64)), image_size=16)


def init(cfg: VGGConfig, generator: torch.Generator | int,
         device=None) -> dict:
    """He-normal conv weights, zero biases, a ``1/sqrt(features)`` head, as
    the reference draws them (other numbers: a ``torch.Generator`` is not a
    JAX key).  ``generator`` must live on ``device`` (a seed makes one
    there); ``device=None`` is the card."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    k = cfg.kernel
    convs = [
        {"w": normal(co, ci, k, k, std=(2.0 / (ci * k * k)) ** 0.5),
         "b": torch.zeros(co, device=device)}
        for ci, co in cfg.conv_shapes()
    ]
    spatial = cfg.image_size // (2 ** len(cfg.stages))
    feat = cfg.stages[-1][-1] * max(spatial, 1) ** 2
    head = {"w": normal(feat, cfg.classes, std=(1.0 / feat) ** 0.5),
            "b": torch.zeros(cfg.classes, device=device)}
    return {"convs": convs, "head": head}


def first_layer_kernels(params: dict, cfg: VGGConfig) -> torch.Tensor:
    """Developer->provider artifact: (alpha, beta, p, p) for ``core.d2r``."""
    return params["convs"][0]["w"].permute(1, 0, 2, 3)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w, b, padding=1)


def apply(
    params: dict, x: torch.Tensor, cfg: VGGConfig,
    aug_matrix: torch.Tensor | None = None,
) -> torch.Tensor:
    """Forward -> logits (B, classes).

    Without ``aug_matrix``, ``x`` is images (B, C, H, W) or unrolled rows
    (B, C*H*W).  With it, ``x`` must be *morphed rows* (B, F) and the first
    conv is replaced by the fixed matrix: one K5 launch
    (:func:`~repro_torch.kernels.ops.aug_conv_forward`), then the first
    layer's bias and ReLU.

    Gradients reach every parameter (``convs[0].b`` and everything after
    it; ``convs[0].w`` is not used on this path) but neither ``aug_matrix``
    nor the rows.  ``C^{ac}`` is a fixed feature extractor: the paper
    trains the network above it, and the reference wraps it in
    ``stop_gradient``; here it is detached.  The rows are the provider's
    data, not parameters, and K5, like the Pallas kernel it replaces, has
    no backward; they are detached too, so a caller's rows that require
    grad never reach the kernel (which would raise).
    """
    geom = cfg.first_geom
    if aug_matrix is not None:
        fr = aug_conv_forward(x.detach(), aug_matrix.detach().to(x.dtype))
        h = reroll_batch(fr, geom.beta, geom.n)
        h = F.relu(h + params["convs"][0]["b"][None, :, None, None])
    else:
        if x.dim() == 2:  # rows (sanity group: plain VGG fed morphed rows)
            x = reroll_batch(x, geom.alpha, geom.m)
        h = F.relu(_conv(x, params["convs"][0]["w"], params["convs"][0]["b"]))

    layer = 1  # conv 0 consumed above
    for si, stage in enumerate(cfg.stages):
        remaining = len(stage) - 1 if si == 0 else len(stage)
        for _ in range(remaining):
            conv = params["convs"][layer]
            h = F.relu(_conv(h, conv["w"], conv["b"]))
            layer += 1
        h = F.max_pool2d(h, 2)
    h = h.reshape(h.shape[0], -1)
    return h @ params["head"]["w"] + params["head"]["b"]


def params_from_jax(tree: dict, device) -> dict:
    """The reference's tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as torch tensors on ``device``
    (no default: the caller says where the weights live)."""
    def conv(node):
        return {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in node.items()}

    return {"convs": [conv(c) for c in tree["convs"]],
            "head": conv(tree["head"])}


class VGG(nn.Module):
    """A thin module over :func:`apply`: a copy of the parameter tree as
    registered parameters (for ``torch.optim``); ``forward`` is ``apply``."""

    def __init__(self, params: dict, cfg: VGGConfig):
        super().__init__()
        self.cfg = cfg

        def own(node):
            return nn.ParameterDict(
                {k: nn.Parameter(v.detach().clone()) for k, v in node.items()}
            )

        self.convs = nn.ModuleList(own(c) for c in params["convs"])
        self.head = own(params["head"])

    def tree(self) -> dict:
        return {"convs": [dict(c) for c in self.convs], "head": dict(self.head)}

    def forward(self, x: torch.Tensor,
                aug_matrix: torch.Tensor | None = None) -> torch.Tensor:
        return apply(self.tree(), x, self.cfg, aug_matrix)
