"""MoLe core on PyTorch — the paper's primary contribution.

Modules (ported from ``repro.core``):
  d2r        data-to-row unrolling + conv-as-matrix (paper §3.1, eq. 1)
  morphing   block-diagonal secret linear morphing (paper §3.2, eqs. 2-4)
  aug_conv   M^{-1}·C fusion + channel randomization (paper §3.3, eq. 5)
  security   attack-probability calculators (paper §4.2, log-space)
  overhead   compute/transmission overhead models (paper §4.3, eqs. 16-17)
  protocol   provider/developer roles end-to-end (paper Fig. 1), vision half
  lm         MoLe for LMs: discrete (token) mode — vocab-permutation
             morphing, fused Aug-Embedding / Aug-head — and continuous
             (embedding) mode — block-diagonal feature morphing, fused
             Aug-projection; the LM session registry
  deploy     fuse_lm_params: provider secrets fused into a params dict
"""
from .d2r import (
    ConvGeometry,
    conv_as_matrix,
    conv_reference,
    d2r_conv_apply,
    reroll,
    reroll_batch,
    unroll,
    unroll_batch,
)
from .morphing import MorphCore, make_core, materialize_M, morph, unmorph
from .aug_conv import (
    AugConv,
    apply_aug_conv,
    build_aug_conv,
    permute_channel_groups,
    random_channel_perm,
)
from .security import MoLeSecurity, analyze as analyze_security
from .overhead import OverheadReport, analyze as analyze_overhead
from .lm import (
    EmbeddingMorpher,
    LMSession,
    LMSessionRegistry,
    TokenMorpher,
    fuse_aug_embedding,
    fuse_aug_head,
    fuse_aug_projection,
)
from .deploy import fuse_lm_params
from .protocol import (
    DataProvider,
    Developer,
    MoLeSession,
    SessionRegistry,
    SlotRegistry,
)

__all__ = [
    "ConvGeometry", "conv_as_matrix", "conv_reference", "d2r_conv_apply",
    "reroll", "reroll_batch", "unroll", "unroll_batch",
    "MorphCore", "make_core", "materialize_M", "morph", "unmorph",
    "AugConv", "apply_aug_conv", "build_aug_conv", "permute_channel_groups",
    "random_channel_perm",
    "MoLeSecurity", "analyze_security",
    "OverheadReport", "analyze_overhead",
    "DataProvider", "Developer", "MoLeSession", "SessionRegistry",
    "SlotRegistry",
    "LMSession", "LMSessionRegistry", "TokenMorpher", "EmbeddingMorpher",
    "fuse_aug_embedding", "fuse_aug_head", "fuse_aug_projection",
    "fuse_lm_params",
]
