# Copied from src/repro/configs/base.py with repro. renamed to repro_torch. and its unused `import jax.numpy as jnp` dropped; keep its logic in step with that file.
"""Unified architecture config covering the 10 assigned families.

A model is a repeating *supercell* of block kinds (``block_pattern``), so
heterogeneous stacks (jamba's 1 attention : 7 mamba, gemma2's
local/global alternation, xlstm's 7 mLSTM : 1 sLSTM) scan over stacked
per-slot parameters with one compiled supercell body.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence


# block kinds
ATTN = "attn"          # global attention
ATTN_LOCAL = "attn_local"  # sliding-window attention (stencil on sequence!)
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    block_pattern: tuple = (ATTN,)   # repeating supercell of block kinds
    moe: Optional[MoEConfig] = None
    moe_every: int = 0               # every k-th layer is MoE (0 = never)
    # attention details
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    logit_softcap: float = 0.0       # gemma2: 30 (attn) handled separately
    attn_softcap: float = 0.0
    local_window: int = 0            # sliding window for ATTN_LOCAL blocks
    # encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # ssm (mamba) details
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # frontend stubs
    modality: Optional[str] = None   # "audio" | "vision" | None
    num_modality_tokens: int = 0     # e.g. 256 vision patches
    modality_dim: int = 0            # raw frontend embedding dim
    # norms / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def supercell(self) -> tuple:
        return self.block_pattern

    @property
    def n_supercells(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not a multiple of "
            f"supercell {len(self.block_pattern)}"
        )
        return self.n_layers // len(self.block_pattern)

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def layer_is_moe(self, i: int) -> bool:
        return self.moe is not None and self.moe_every > 0 and (
            i % self.moe_every == self.moe_every - 1
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in (ATTN, ATTN_LOCAL):
                qkvo = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
                total += qkvo
            elif kind == MAMBA:
                di = self.ssm_expand * self.d_model
                total += 2 * d * di + di * self.ssm_conv_width
                total += di * self.ssm_state_dim * 2 + di  # dt/B/C projections (approx)
                total += di * d
            elif kind in (MLSTM, SLSTM):
                di = 2 * d if kind == MLSTM else d
                total += 4 * d * di + di * d
            if dff > 0:
                ffn = 3 * d * dff  # SwiGLU
                if self.layer_is_moe(i):
                    assert self.moe is not None
                    total += ffn * self.moe.num_experts + d * self.moe.num_experts
                else:
                    total += ffn
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of experts)."""
        if self.moe is None or self.moe_every == 0:
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        full = self.param_count()
        n_moe = sum(1 for i in range(self.n_layers) if self.layer_is_moe(i))
        inactive = n_moe * 3 * d * dff * (self.moe.num_experts - self.moe.top_k)
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    cell = len(cfg.block_pattern)
    small = dict(
        n_layers=cell if cfg.n_layers >= cell else cfg.n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_ff=128 if cfg.d_ff > 0 else 0,
        vocab_size=128,
        head_dim=16,
        ssm_state_dim=8,
        num_modality_tokens=4 if cfg.num_modality_tokens else 0,
        # audio frames enter the encoder at d_model; vision keeps a distinct
        # frontend width exercised through the projector
        modality_dim=(64 if cfg.modality_dim == cfg.d_model else 32)
        if cfg.modality_dim
        else 0,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        local_window=8 if cfg.local_window else 0,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            num_experts=4, top_k=min(cfg.moe.top_k, 2), capacity_factor=2.0
        )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
