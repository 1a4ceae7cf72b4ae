"""Configuration dataclasses for the repro framework.

Every architecture is described by a ``ModelConfig``; every workload cell by a
``ShapeConfig``. Configs are plain frozen dataclasses so they hash, print, and
serialize cleanly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_expert: int = 0              # expert FFN hidden size (fine-grained may differ from d_ff)
    capacity_factor: float = 1.25  # for the capacity-based (shardable) path
    router_jitter: float = 0.0
    # impl: "capacity" (einsum dispatch, shards via GSPMD; used for dry-run/train)
    #       "dropless" (sort + ragged gmm; exact, used by the serving engine)
    impl: str = "capacity"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (seamless). Frontend is a stub:
    the encoder consumes precomputed frame embeddings (B, frames, d_model)."""
    n_layers: int = 24
    cross_attn_memory: int = 1024  # encoder memory length seen by decode shapes


@dataclass(frozen=True)
class VisionConfig:
    """VLM frontend stub: precomputed patch embeddings (B, n_patches, d_patch)
    plus a real, sharded linear projector into the LM d_model."""
    n_patches: int = 576
    d_patch: int = 1024


@dataclass(frozen=True)
class LayerGroup:
    """A repeating block pattern. ``pattern`` is a string over:
      'A' full attention    'L' local (sliding-window) attention
      'G' global attention  'M' mamba2 (SSD)
    ``moe_mask`` marks which positions within the pattern use a MoE MLP
    (None = all dense, or a string of '0'/'1' with len == len(pattern)).
    Params for a group are stacked on a leading ``repeats`` dim and the body
    runs as a Python loop over repeats.
    """
    pattern: str
    repeats: int
    moe_mask: Optional[str] = None

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    sliding_window: int = 0        # >0: window size for 'L' layers
    attn_softcap: float = 0.0      # gemma2: 50.0
    logit_softcap: float = 0.0     # gemma2: 30.0
    tie_embeddings: bool = False
    scale_embedding: bool = False  # gemma: x *= sqrt(d_model) after embed
    dense_d_ff: int = 0            # deepseek: first layer dense-FFN width
    act: str = "silu"              # silu (SwiGLU) | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    layer_groups: Tuple[LayerGroup, ...] = ()
    source: str = ""               # provenance tag from the assignment table

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if not self.layer_groups:
            pat = "M" if self.family == "ssm" else "A"
            object.__setattr__(
                self, "layer_groups", (LayerGroup(pattern=pat, repeats=self.n_layers),)
            )
        got = sum(g.n_layers for g in self.layer_groups)
        assert got == self.n_layers, f"{self.name}: layer_groups cover {got} != n_layers {self.n_layers}"

    # -- derived ------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return all(c == "M" for g in self.layer_groups for c in g.pattern)

    @property
    def has_subquadratic_path(self) -> bool:
        """True if the arch can serve 500k context: attention-free, hybrid, or
        sliding-window on a fraction of layers (bounded-cache local attention
        + mesh-sharded global cache)."""
        chars = [c for g in self.layer_groups for c in g.pattern]
        return any(c in ("M", "L") for c in chars)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params; used for 6ND)."""
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self, active_only=True)

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped). long_500k is skipped for pure
    full-attention archs per the assignment; see DESIGN.md §4."""
    if shape.name == "long_500k" and not model.has_subquadratic_path:
        return False, "pure full-attention arch: 524k context not deployable (skip per DESIGN.md)"
    return True, ""
