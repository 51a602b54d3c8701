"""Overhead analysis (paper §4.3) and reference MAC models.

Provider-side morphing cost per sample (true cost; see note below):
    O_comp_dp = alpha m^2 * q = F * q      (each of F outputs needs q MACs)
The paper's eq. (16) prints ``alpha * q^2``; the two agree iff kappa == alpha.
We implement the true cost and expose the paper's literal formula alongside —
the discrepancy is documented in DESIGN.md §1 and flagged by the benchmark.

Developer-side extra MACs per sample (eq. 17):
    O_comp_dev = (m^2 - p^2) * alpha * beta * n^2

Transmission overhead (one-time, per protocol run):
    O_data = (alpha m^2)^2   elements (the fused C^{ac} matrix)

Reference totals used for the paper's ratios:
  * VGG-16 on 32x32 CIFAR inputs (conv MACs computed layer-by-layer);
  * ResNet-152 on 224x224 ImageNet inputs (bottleneck stack computed exactly) —
    reproduces the paper's "10x" claim from eq. 17.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "morph_macs",
    "morph_macs_paper_eq16",
    "aug_conv_extra_macs",
    "transmission_elements",
    "vgg16_cifar_macs",
    "resnet152_imagenet_macs",
    "OverheadReport",
    "analyze",
]


def morph_macs(alpha: int, m: int, kappa: int) -> int:
    """True provider-side MACs per sample: F * q with F = alpha m^2."""
    f = alpha * m * m
    return f * (f // kappa)


def morph_macs_paper_eq16(alpha: int, m: int, kappa: int) -> int:
    """The paper's literal eq. (16): alpha * q^2."""
    q = alpha * m * m // kappa
    return alpha * q * q


def aug_conv_extra_macs(alpha: int, m: int, p: int, beta: int, n: int) -> int:
    """Eq. (17): dense C^{ac} GEMM minus the original conv's MACs."""
    return (m * m - p * p) * alpha * beta * n * n


def transmission_elements(alpha: int, m: int) -> int:
    """Elements of C^{ac} shipped once per protocol run: (alpha m^2)^2.

    Note: C^{ac} has alpha m^2 x beta n^2 elements in general; the paper
    quotes (alpha m^2)^2, exact for the VGG/CIFAR case (beta n^2 == alpha m^2
    ... 64*1024 vs 3*1024 differ; the paper's CIFAR arithmetic uses
    (alpha m^2)^2 = 3072^2 and lands exactly on 5.12%, so we keep its
    accounting and also expose the general product).
    """
    return (alpha * m * m) ** 2


def transmission_elements_general(alpha: int, m: int, beta: int, n: int) -> int:
    return (alpha * m * m) * (beta * n * n)


# --------------------------------------------------------------------------
# Reference MAC models
# --------------------------------------------------------------------------

# VGG-16 conv stack: (in_ch, out_ch, spatial_out) for 32x32 inputs, stride-1
# SAME 3x3 convs with 2x2 maxpool after each stage.
_VGG16_CIFAR = [
    (3, 64, 32), (64, 64, 32),
    (64, 128, 16), (128, 128, 16),
    (128, 256, 8), (256, 256, 8), (256, 256, 8),
    (256, 512, 4), (512, 512, 4), (512, 512, 4),
    (512, 512, 2), (512, 512, 2), (512, 512, 2),
]


def vgg16_cifar_macs(include_fc: bool = True) -> int:
    macs = sum(ci * co * 9 * s * s for ci, co, s in _VGG16_CIFAR)
    if include_fc:
        macs += 512 * 512 + 512 * 512 + 512 * 10  # CIFAR-VGG style classifier
    return macs


def resnet152_imagenet_macs() -> int:
    """Exact conv MACs of ResNet-152 (bottleneck [3, 8, 36, 3]) at 224x224."""
    macs = 3 * 64 * 49 * 112 * 112  # conv1 7x7/2
    stages = [
        (64, 64, 256, 3, 56),
        (256, 128, 512, 8, 28),
        (512, 256, 1024, 36, 14),
        (1024, 512, 2048, 3, 7),
    ]
    for c_in, width, c_out, blocks, s in stages:
        for b in range(blocks):
            cin = c_in if b == 0 else c_out
            macs += cin * width * s * s            # 1x1 reduce
            macs += width * width * 9 * s * s      # 3x3
            macs += width * c_out * s * s          # 1x1 expand
            if b == 0:
                macs += cin * c_out * s * s        # projection shortcut
    macs += 2048 * 1000  # fc
    return macs


@dataclasses.dataclass(frozen=True)
class OverheadReport:
    morph_macs_per_sample: int
    morph_macs_paper_eq16: int
    aug_extra_macs_per_sample: int
    network_macs_per_sample: int
    compute_overhead_ratio: float       # aug_extra / network (developer side)
    transmission_elements: int
    dataset_elements: int
    transmission_overhead_ratio: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(
    *,
    alpha: int,
    beta: int,
    m: int,
    n: int,
    p: int,
    kappa: int,
    network_macs: int,
    dataset_images: int,
) -> OverheadReport:
    aug = aug_conv_extra_macs(alpha, m, p, beta, n)
    tx = transmission_elements(alpha, m)
    ds = dataset_images * alpha * m * m
    return OverheadReport(
        morph_macs_per_sample=morph_macs(alpha, m, kappa),
        morph_macs_paper_eq16=morph_macs_paper_eq16(alpha, m, kappa),
        aug_extra_macs_per_sample=aug,
        network_macs_per_sample=network_macs,
        compute_overhead_ratio=aug / network_macs,
        transmission_elements=tx,
        dataset_elements=ds,
        transmission_overhead_ratio=tx / ds,
    )
