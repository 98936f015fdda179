"""Architecture configuration: the port's copy of ``repro/configs/base.py``.

Every architecture is an :class:`ArchConfig`; ``reduced()`` yields a tiny
same-family config for CPU tests, field for field the one the JAX package
derives, so both packages build the same reduced models.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_ff_expert: int
    first_dense_layers: int = 0          # leading layers use the dense FFN
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    q_lora_rank: Optional[int] = None    # None => direct q projection


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 1                      # inner dim multiplier
    dt_rank: int = 32


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_free: bool = False              # RWKV: no attention at all
    encoder_layers: int = 0              # enc-dec only
    encoder_seq: int = 0                 # fixed encoder length (frames)
    frontend: str = "none"               # none | audio | vision
    n_frontend_tokens: int = 0           # image patch tokens prepended
    sliding_window: Optional[int] = None  # attention window (hybrid long ctx)
    sub_quadratic: bool = False          # supports long_500k
    notes: str = ""

    # ---- derived ------------------------------------------------------------

    @property
    def q_dim(self) -> int:
        if self.mla:
            return self.n_heads * (self.mla.nope_head_dim
                                   + self.mla.rope_head_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def n_params(self) -> int:
        """Total parameter count (embedding + layers + head)."""
        from ..models.lm import count_params
        return count_params(self)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        from ..models.lm import count_params
        return count_params(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        scale_heads = max(self.n_heads // self.n_kv_heads, 1)
        n_kv = max(self.n_kv_heads // 4, 1)
        kw.update(
            n_layers=2, d_model=64, n_heads=n_kv * min(scale_heads, 4),
            n_kv_heads=n_kv, head_dim=16, d_ff=128, vocab_size=512,
        )
        if self.attn_free:                   # RWKV: n_heads * head_dim == d
            kw.update(n_heads=4, n_kv_heads=4, head_dim=16)
        if self.moe:
            kw["moe"] = MoEConfig(n_routed=4, n_shared=self.moe.n_shared and 1,
                                  top_k=2, d_ff_expert=32,
                                  first_dense_layers=min(
                                      self.moe.first_dense_layers, 1))
        else:
            kw["moe"] = None
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                                  nope_head_dim=16, v_head_dim=16,
                                  q_lora_rank=None)
            kw["head_dim"] = 16
        else:
            kw["mla"] = None
        kw["ssm"] = SSMConfig(state_dim=4, dt_rank=4) if self.ssm else None
        if self.encoder_layers:
            kw["encoder_layers"] = 2
            kw["encoder_seq"] = 32
        if self.n_frontend_tokens:
            kw["n_frontend_tokens"] = 8
        if self.sliding_window:
            kw["sliding_window"] = 16
        for k in ("moe", "mla", "ssm"):
            if isinstance(kw[k], dict):
                kw[k] = None
        return ArchConfig(**kw)



@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode | long_decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "long_decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_is_runnable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if skipped.

    ``long_500k`` needs a sub-quadratic sequence mixer; pure full-attention
    architectures skip it (documented in DESIGN.md Sec. 5)."""
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return False, ("long_500k skipped: pure full-attention architecture "
                       "(O(S^2)); see DESIGN.md §Arch-applicability")
    return True, ""
