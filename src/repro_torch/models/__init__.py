"""Model zoo on PyTorch: the dense token LMs the port serves so far.

  base    configs (copied from ``repro.models.base``) + parameter init
  layers  norms, RoPE, dense/decode attention, gated MLPs
  blocks  the dense global self-attention block
  stack   embedding -> blocks -> final norm -> LM head
  api     ``Model`` and ``params_from_jax``
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

__all__ = [
    "FrontendCfg", "MLACfg", "MoECfg", "MoLeCfg", "ModelConfig", "ParamDef",
    "ParamTree", "RnnCfg", "RwkvCfg", "check_supported", "init_params",
    "Model", "params_from_jax",
]
