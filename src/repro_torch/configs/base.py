"""Config dataclasses for architectures and serving shapes.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing of
that package): ``ModelConfig``, ``ShapeConfig``, the layer kinds and
``smoke_config``, field for field, so both packages size a model the same.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# Layer kinds used to build the per-layer pattern of a model. One *group* is
# one period of the pattern.
ATTN = "attn"            # full (global) self-attention
LOCAL_ATTN = "local"     # sliding-window self-attention
MAMBA = "mamba"          # Mamba2 SSD mixer
SHARED_ATTN = "shared"   # zamba2-style shared-weight attention block


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    pattern: Tuple[str, ...] = (ATTN,)
    window: int = 0                  # sliding window size for LOCAL_ATTN
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    n_prefix_tokens: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    sub_quadratic: bool = False
    max_position: int = 1 << 20

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    def kinds(self) -> Tuple[str, ...]:
        """Full per-layer kind sequence (pattern tiled to n_layers)."""
        return tuple(self.pattern[i % len(self.pattern)]
                     for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (matches init exactly)."""
        d = self.d_model
        n = self.vocab_size * d                        # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_kind = {}
        attn_p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp_p = 3 * d * self.d_ff                      # SwiGLU: gate/up/down
        if self.moe is not None:
            mlp_p = self.moe.n_experts * 3 * d * self.d_ff + d * self.moe.n_experts
        per_kind[ATTN] = attn_p + mlp_p + 2 * d
        per_kind[LOCAL_ATTN] = per_kind[ATTN]
        if self.ssm is not None:
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            in_p = d * (2 * di + 2 * self.ssm.d_state + nh)
            conv_p = (di + 2 * self.ssm.d_state) * self.ssm.conv_width
            extra = nh * 3
            out_p = di * d + di
            per_kind[MAMBA] = in_p + conv_p + extra + out_p + d
        shared = 0
        if SHARED_ATTN in self.pattern:
            shared = attn_p + 3 * d * self.d_ff + 2 * d
        for k in self.kinds():
            if k == SHARED_ATTN:
                continue
            n += per_kind[k]
        n += shared
        n += d                                         # final norm
        if self.n_encoder_layers:
            enc = self.n_encoder_layers * (attn_p + mlp_p + 2 * d) + d
            cross = self.n_layers * (attn_p + d)
            n += enc + cross
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: small dims, few layers, tiny vocab."""
    if cfg.n_kv_heads <= 1:
        smoke_kv = 1                       # preserve MQA
    elif cfg.n_kv_heads < cfg.n_heads:
        smoke_kv = 2                       # preserve GQA
    else:
        smoke_kv = 4                       # preserve MHA
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=len(cfg.pattern) * min(2, cfg.n_groups),
        d_model=64,
        n_heads=4,
        n_kv_heads=smoke_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 32) if cfg.window else 0,
        max_position=4096,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=8, top_k=min(cfg.moe.top_k, 2),
                              capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=16, chunk=16)
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = 2
        kw["encoder_seq"] = 16
    if cfg.n_prefix_tokens:
        kw["n_prefix_tokens"] = 4
    return replace(cfg, **kw)
