"""Model substrate on PyTorch: configs and parameter initialisation.

Ported from ``repro.models.base``.  The config dataclasses are the
reference's, copied verbatim so that a config reads the same in both
packages.  The reference's ``ParamDef`` schema keeps its shape, its
logical sharding axes (which :mod:`repro_torch.sharding.rules` maps to mesh
axes) and its init rule; the port keeps one leaf per layer where the
reference stacks a group's layers under a leading ``"layers"`` axis, so a
port leaf's axes are the reference's without that entry.  ``init_params``
draws every parameter from an explicit ``torch.Generator`` on the target device,
with the reference's init rules (the numbers differ from ``jax.random``'s:
tests carry the reference's parameters over with
``repro_torch.models.api.params_from_jax``).  :class:`ParamTree` is the
``nn.Module`` that holds a nested parameter tree and is indexed by name like
the reference's parameter dicts (``params["blocks"][i]["mix"]["wq"]``).

The port runs attention stacks (global and sliding-window layers,
DeepSeek-V2's multi-head latent attention, dense or fine-grained MoE
FFNs), RecurrentGemma's hybrid of RG-LRU and local-attention layers,
RWKV-6 stacks, vision-language stacks whose gated cross-attention layers
attend to a stubbed patch stream, and Whisper's audio encoder-decoder:
:func:`check_supported` raises ``NotImplementedError`` for every config
that combines these in a way the reference's configs do not.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

__all__ = [
    "MoECfg", "MLACfg", "RnnCfg", "RwkvCfg", "FrontendCfg", "MoLeCfg",
    "ModelConfig", "ParamDef", "ParamTree", "abstract_params",
    "check_supported", "init_params", "param_axes", "torch_dtype",
]

# ---------------------------------------------------------------------------
# Configs (the reference's, in repro.models.base, copied)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_routed: int
    n_shared: int
    top_k: int
    d_ff_expert: int
    first_dense_ff: int | None = None   # dense FFN width for prefix layers
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    norm_topk: bool = False


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class RnnCfg:
    """RG-LRU recurrent block (Griffin / RecurrentGemma)."""

    d_rnn: int = 0            # 0 => same as d_model
    conv_width: int = 4
    c: float = 8.0            # decay sharpness constant
    block_width_divisor: int = 1


@dataclasses.dataclass(frozen=True)
class RwkvCfg:
    head_dim: int = 64
    chunk: int = 16           # chunked linear-attention chunk length
    subchunk: int = 0         # >0: GEMM-form intra-chunk (EXPERIMENTS §Perf h3)
    ddlerp_rank: int = 32     # low-rank data-dependent interpolation (token shift)
    decay_rank: int = 64


@dataclasses.dataclass(frozen=True)
class FrontendCfg:
    """Stubbed modality frontend: input_specs provides precomputed embeddings."""

    kind: str                 # "vision" | "audio"
    d_in: int                 # per-position feature dim delivered by the stub
    n_tokens: int             # number of frontend positions (patches / frames)
    cross_gated: bool = True  # tanh-gated cross-attn (llama-3.2-vision style)
    enc_layers: int = 0       # encoder depth (whisper-style enc-dec only)

    @property
    def batch_key(self) -> str:
        """The batch input the stub fills: an audio model's frames, a
        vision model's patches."""
        return "frames" if self.kind == "audio" else "patches"


@dataclasses.dataclass(frozen=True)
class MoLeCfg:
    """MoLe secure-delivery feature flags (DESIGN.md §4)."""

    enabled: bool = False
    mode: str = "token"       # "token" (vocab permutation) | "embedding" (block-diag)
    kappa: int = 1
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | vlm | audio
    vocab: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    block_pattern: tuple[str, ...]        # layer kinds, scanned n_groups times
    n_groups: int
    prefix_pattern: tuple[str, ...] = ()  # unscanned leading layers
    suffix_pattern: tuple[str, ...] = ()  # unscanned trailing layers
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    act: str = "swiglu"                   # swiglu | geglu | gelu
    parallel_block: bool = False          # command-r style attn+ffn in parallel
    post_norm: bool = False               # gemma2 extra post-sublayer norms
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    attn_scale: float | None = None       # None => head_dim ** -0.5
    attn_softcap: float | None = None
    final_softcap: float | None = None
    scale_embedding: bool = False
    tie_embeddings: bool = False
    qkv_bias: bool = False
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    rnn: RnnCfg | None = None
    rwkv: RwkvCfg | None = None
    frontend: FrontendCfg | None = None
    mole: MoLeCfg = dataclasses.field(default_factory=MoLeCfg)
    dtype: str = "bfloat16"               # activation dtype
    param_dtype: str = "bfloat16"
    flash_block_kv: int = 1024            # flash-scan KV chunk
    dense_attn_max_seq: int = 1024        # use dense attention at/below this
    scan_unroll: bool = False             # unroll layer scans (analysis passes:
                                          # XLA:CPU cost_analysis counts while
                                          # bodies once; see launch/dryrun.py)
    fused_ce: bool = True                 # chunked softmax-CE (never builds
                                          # (B,S,V) logits; §Perf beyond-paper 4)
    source: str = ""                      # provenance note

    @property
    def n_layers(self) -> int:
        return (
            len(self.prefix_pattern)
            + self.n_groups * len(self.block_pattern)
            + len(self.suffix_pattern)
        )

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def layer_kinds(self) -> list[str]:
        return (
            list(self.prefix_pattern)
            + list(self.block_pattern) * self.n_groups
            + list(self.suffix_pattern)
        )

    def param_count(self) -> int:
        """Total parameter count (from the schema, exact; an audio model's
        encoder included)."""
        # local imports to avoid a cycle
        from .stack import model_schema
        from .whisper import whisper_schema

        def size(node) -> int:
            if isinstance(node, ParamDef):
                return math.prod(node.shape)
            values = node.values() if isinstance(node, dict) else node
            return sum(size(v) for v in values)

        schema = whisper_schema if self.family == "audio" else model_schema
        return size(schema(self))

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k routed experts)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        m = self.moe
        n_moe_layers = sum(1 for k in self.layer_kinds() if k.endswith("_moe"))
        per_expert = 3 * self.d_model * m.d_ff_expert
        inactive = n_moe_layers * (m.n_routed - m.top_k) * per_expert
        return total - inactive


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the configs name dtypes as JAX
    does)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


_ATTN_KINDS = ("attn", "global", "local")  # the dense self-attention kinds
# the kinds of an MoE stack: global attention or MLA, each with a dense or
# a fine-grained MoE FFN
_MOE_KINDS = ("attn_moe", "mla", "mla_moe")
_REC_KINDS = ("rec",)   # the RG-LRU mixer of a hybrid stack
_CROSS_KINDS = ("cross",)   # gated cross-attention over a vlm's patches
_DEC_KINDS = ("dec",)   # whisper's decoder layer: self, cross, FFN


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg``: a stack
    of ``family`` "dense" or "moe" whose layers (prefix, scanned pattern
    and suffix) are all of the kinds ``attn`` / ``global`` (global
    attention), ``local`` (attention in ``sliding_window``), ``mla``
    (multi-head latent attention, with an ``MLACfg``) and ``attn_moe`` /
    ``mla_moe`` (the same mixers with a fine-grained MoE FFN, with a
    ``MoECfg``; a "moe" family has one); a ``family="hybrid"`` stack of
    ``rec`` (RG-LRU, with an ``RnnCfg``) and the dense attention kinds; a
    ``family="vlm"`` stack of ``cross`` (cross-attention over the patch
    stream, tanh-gated or not) and the dense attention kinds, with a
    ``vision`` frontend; a ``family="audio"`` decoder of ``dec`` layers
    alone (no prefix, suffix, MoE, MLA or window) with an ``audio``
    frontend of ``enc_layers > 0`` bidirectional encoder layers and
    ungated cross-attention; or an RWKV-6 stack (``family="ssm"``,
    ``("rwkv",)``, ``rwkv`` set, layernorm).  No other config has a
    frontend.  Nothing else is computed in its place."""
    rwkv = tuple(cfg.block_pattern) == ("rwkv",)
    vlm = cfg.family == "vlm"
    audio = cfg.family == "audio"
    later = []
    if rwkv:
        if cfg.family != "ssm":
            later.append(f"family={cfg.family!r} with rwkv blocks")
        if cfg.rwkv is None:
            later.append("rwkv blocks without an RwkvCfg")
        if cfg.norm != "layernorm":
            later.append(f"rwkv blocks with norm={cfg.norm!r}")
        if cfg.prefix_pattern or cfg.suffix_pattern:
            later.append("prefix/suffix layers beside rwkv blocks")
        if cfg.sliding_window is not None:
            later.append("sliding_window with rwkv blocks")
        for name in ("moe", "mla", "rnn"):
            if getattr(cfg, name) is not None:
                later.append(f"{name} with rwkv blocks")
    else:
        kinds = set(cfg.layer_kinds())
        hybrid = cfg.family == "hybrid"
        if cfg.family not in ("dense", "moe", "hybrid", "vlm", "audio"):
            later.append(f"family={cfg.family!r}")
        if cfg.family == "moe" and cfg.moe is None:
            later.append("family='moe' without a MoECfg")
        ported = (_DEC_KINDS if audio else _ATTN_KINDS + (
            _REC_KINDS if hybrid else _CROSS_KINDS if vlm else _MOE_KINDS))
        unknown = sorted(kinds - set(ported))
        if unknown:
            later.append(f"layer kinds {unknown} in family={cfg.family!r}")
        if cfg.moe is None and any(k.endswith("_moe") for k in kinds):
            later.append("_moe layers without a MoECfg")
        if cfg.mla is None and kinds & {"mla", "mla_moe"}:
            later.append("mla layers without an MLACfg")
        if cfg.rnn is None and "rec" in kinds:
            later.append("rec layers without an RnnCfg")
        if cfg.rnn is not None and not hybrid:
            later.append("rnn")
        if cfg.rwkv is not None:
            later.append("rwkv")
        if audio:
            if cfg.prefix_pattern or cfg.suffix_pattern:
                later.append("prefix/suffix layers in an audio stack")
            if cfg.sliding_window is not None:
                later.append("sliding_window in an audio stack")
            for name in ("moe", "mla"):
                if getattr(cfg, name) is not None:
                    later.append(f"{name} in an audio stack")
    fe = cfg.frontend
    if fe is None:
        if vlm or audio:
            later.append(f"family={cfg.family!r} without a frontend")
    elif vlm:
        if fe.kind != "vision" or fe.enc_layers:
            later.append(f"a {fe.kind} frontend of {fe.enc_layers} encoder "
                         f"layers in family='vlm'")
    elif audio:
        if fe.kind != "audio" or fe.enc_layers <= 0 or fe.cross_gated:
            later.append(f"a {fe.kind} frontend of {fe.enc_layers} encoder "
                         f"layers (cross_gated={fe.cross_gated}) in "
                         f"family='audio'")
    else:
        later.append(f"a {fe.kind} frontend in family={cfg.family!r}")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} not ported (the port runs "
            f"stacks of global and sliding-window attention, MLA and "
            f"fine-grained MoE blocks, RG-LRU hybrids, RWKV-6 stacks, "
            f"vision-language stacks of attention and cross-attention "
            f"layers behind a vision frontend, and audio encoder-decoders "
            f"of bidir encoder and dec decoder layers behind an audio "
            f"frontend)"
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # one logical axis name (or None) a dim
    init: str = "normal"        # normal | zeros | ones | neg_ones | embed
    scale: float | None = None  # None => 1/sqrt(fan_in) for normal
    dtype: torch.dtype | None = None   # None => caller's default dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _map_defs(fn, schema):
    """``fn`` over every ``ParamDef`` of a schema (nested dicts / lists),
    keeping the schema's structure."""
    if isinstance(schema, ParamDef):
        return fn(schema)
    if isinstance(schema, dict):
        return {k: _map_defs(fn, v) for k, v in schema.items()}
    return [_map_defs(fn, v) for v in schema]


def param_axes(schema):
    """The logical axes of every leaf, in the schema's structure."""
    return _map_defs(lambda d: d.axes, schema)


def abstract_params(schema, dtype: torch.dtype):
    """Every leaf as a tensor on the ``meta`` device (shape and dtype, no
    storage), in the schema's structure: the rules read shapes from it
    without allocating a full-size model."""
    return _map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype or dtype, device="meta"),
        schema)


def _init_one(d: ParamDef, dtype: torch.dtype, generator: torch.Generator,
              device) -> torch.Tensor:
    dtype = d.dtype or dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "neg_ones":
        return torch.full(d.shape, -1, dtype=dtype, device=device)
    scale = d.scale
    if scale is None:
        if d.init == "embed":
            scale = 1.0
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = 1.0 / math.sqrt(fan_in)
    v = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return v.mul_(scale).to(dtype)


def init_params(schema, dtype: torch.dtype, generator: torch.Generator | None,
                device):
    """Concrete tensors for a schema (nested dicts / lists of ``ParamDef``),
    leaf by leaf in the schema's order: ``zeros`` / ``ones`` / ``neg_ones``,
    else a standard normal drawn in fp32 times the scale, then cast."""
    if isinstance(schema, ParamDef):
        return _init_one(schema, dtype, generator, device)
    if isinstance(schema, dict):
        return {k: init_params(v, dtype, generator, device)
                for k, v in schema.items()}
    return [init_params(v, dtype, generator, device) for v in schema]


class ParamTree(nn.Module):
    """A nested parameter tree as an ``nn.Module``.

    Built from nested dicts / lists of tensors (or subtrees already built);
    indexed by name (or position for lists) like the reference's parameter
    pytrees, so the functional blocks read ``p["mix"]["wq"]`` in both
    packages, and ``dict(tree)`` gives its top level.  Leaves are built
    with ``requires_grad=False``, so serving records no autograd graph; a
    trainer turns grad on for the leaves it trains for the span of its step
    (:func:`repro_torch.launch.steps.make_train_step`).
    """

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            elif isinstance(v, nn.Module):
                self.add_module(k, v)
            elif isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
            else:
                raise TypeError(f"{k}: unsupported leaf {type(v).__name__}")

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def keys(self) -> tuple[str, ...]:
        return self._keys
