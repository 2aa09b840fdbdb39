"""Shared model configuration and parameter accounting (PyTorch port of
``repro.models.common``; dtypes are torch dtypes)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    #: d_ff of the dense FFN used by any ``dense`` layers in the pattern
    dense_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture, exactly as assigned (see repro_torch.configs.<id>)."""

    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False  # qwen2-vl 3-axis M-RoPE
    sliding_window: int = 0  # 0 = full attention
    local_global_period: int = 0  # gemma3: every Nth layer is global
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    #: layer-type string per layer; None -> all "attn"
    layer_pattern: tuple[str, ...] | None = None
    encoder_layers: int = 0  # enc-dec: first N layers are the encoder
    embed_input: bool = False  # vlm/audio: inputs are precomputed embeddings
    act: str = "swiglu"
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    #: hybrid (zamba2): period of the shared attention block (0 = none)
    shared_attn_period: int = 0
    sub_quadratic: bool = False  # eligible for the long_500k shape

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.layer_pattern is not None:
            return self.layer_pattern
        if self.local_global_period:
            p = self.local_global_period
            return tuple(
                "attn_global" if (i + 1) % p == 0 else "attn_local"
                for i in range(self.num_layers)
            )
        if self.encoder_layers:
            return tuple(
                "enc" if i < self.encoder_layers else "dec"
                for i in range(self.num_layers)
            )
        if self.family == "moe":
            assert self.moe is not None
            return tuple(
                "dense" if (i == 0 and self.moe.dense_d_ff) else "moe"
                for i in range(self.num_layers)
            )
        return tuple("attn" for _ in range(self.num_layers))

    def layer_types(self) -> tuple[str, ...]:
        """Distinct layer types, in switch-branch order."""
        seen: list[str] = []
        for t in self.pattern:
            if t not in seen:
                seen.append(t)
        return tuple(seen)

    # ------------------------------------------------------------------
    def padded_vocab(self, multiple: int = 16) -> int:
        return int(math.ceil(self.vocab_size / multiple) * multiple)

    # ---- parameter accounting (for 6·N·D roofline terms) --------------
    def layer_param_count(self, kind: str) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        ffn = glu * d * self.d_ff
        norms = 2 * d
        if kind in ("attn", "attn_local", "attn_global", "enc"):
            return attn + ffn + norms
        if kind == "dec":  # + cross attention
            return 2 * attn + ffn + norms + d
        if kind == "dense":
            assert self.moe is not None
            return attn + glu * d * self.moe.dense_d_ff + norms
        if kind == "moe":
            assert self.moe is not None
            e = self.moe.num_experts + self.moe.num_shared
            return attn + e * glu * d * self.d_ff + d * self.moe.num_experts + norms
        if kind == "mamba":
            assert self.ssm is not None
            di = self.ssm.d_inner(d)
            nh = self.ssm.num_heads(d)
            # in_proj -> (z, x, B, C, dt), conv, out_proj, A/D/dt_bias, norm
            in_p = d * (2 * di + 2 * self.ssm.d_state + nh)
            conv = self.ssm.d_conv * (di + 2 * self.ssm.d_state)
            return in_p + conv + di * d + 3 * nh + di + d
        if kind == "mlstm":
            hd_x = d // self.num_heads
            return 4 * d * d + 3 * d + 2 * d  # q,k,v,o + gates + norms
        if kind == "slstm":
            return 4 * d * d + 4 * d + 2 * d
        raise ValueError(kind)

    def active_layer_param_count(self, kind: str) -> int:
        """Parameters touched per token (MoE: shared + top-k experts)."""
        if kind != "moe":
            return self.layer_param_count(kind)
        assert self.moe is not None
        d = self.d_model
        hd = self.resolved_head_dim
        attn = (
            d * (self.num_heads * hd)
            + 2 * d * (self.num_kv_heads * hd)
            + (self.num_heads * hd) * d
        )
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        e_active = self.moe.top_k + self.moe.num_shared
        return attn + e_active * glu * d * self.d_ff + d * self.moe.num_experts + 2 * d

    def param_count(self, include_embed: bool = True) -> int:
        n = sum(self.layer_param_count(k) for k in self.pattern)
        if self.shared_attn_period:
            n += self.layer_param_count("attn")  # one shared block
        n += self.d_model  # final norm
        if include_embed:
            n += 2 * self.padded_vocab() * self.d_model
        return n

    def active_param_count(self) -> int:
        """Parameters *touched per token* (compute accounting): the shared
        attention block counts once per invocation, not once per copy."""
        n = sum(self.active_layer_param_count(k) for k in self.pattern)
        if self.shared_attn_period:
            invocations = len(range(0, self.num_layers, self.shared_attn_period))
            n += invocations * self.layer_param_count("attn")
        n += self.d_model
        return n


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "train"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Stage layout
# ---------------------------------------------------------------------------
def stage_layout(num_layers: int, num_stages: int) -> tuple[np.ndarray, int]:
    """Distribute ``num_layers`` across stages.

    Returns (counts[num_stages], l_max).  Later stages may hold one fewer
    layer; disabled slots are skipped via per-layer enabled flags.
    """
    base = num_layers // num_stages
    extra = num_layers - base * num_stages
    counts = np.full(num_stages, base, dtype=np.int64)
    counts[:extra] += 1
    return counts, int(counts.max())


def global_layer_index(counts: np.ndarray) -> np.ndarray:
    """[num_stages, l_max] global layer id per slot (-1 = disabled)."""
    S, l_max = len(counts), int(counts.max())
    out = np.full((S, l_max), -1, dtype=np.int64)
    g = 0
    for s in range(S):
        for i in range(int(counts[s])):
            out[s, i] = g
            g += 1
    return out
