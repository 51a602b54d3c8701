"""Model zoo on PyTorch: the token LMs the port serves so far (dense
global attention, RWKV-6), and the paper's VGG.

  base    configs (copied from ``repro.models.base``) + parameter init
  layers  norms, RoPE, dense/flash-scan/decode attention, gated MLPs
  blocks  the dense global self-attention block and the RWKV-6 block
  stack   embedding -> blocks -> final norm -> LM head
  api     ``Model`` and ``params_from_jax``
  cnn     VGG-16 on CIFAR with the Aug-Conv first layer (paper §4.4)
"""
from .base import (
    FrontendCfg,
    MLACfg,
    MoECfg,
    MoLeCfg,
    ModelConfig,
    ParamDef,
    ParamTree,
    RnnCfg,
    RwkvCfg,
    check_supported,
    init_params,
)
from .api import Model, params_from_jax
from . import cnn

__all__ = [
    "FrontendCfg", "MLACfg", "MoECfg", "MoLeCfg", "ModelConfig", "ParamDef",
    "ParamTree", "RnnCfg", "RwkvCfg", "check_supported", "init_params",
    "Model", "params_from_jax", "cnn",
]
