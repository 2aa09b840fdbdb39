"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.common import ArchConfig, MoEConfig, SSMConfig

_MODULES = {
    "granite-34b": "granite_34b",
    "gemma3-4b": "gemma3_4b",
    "qwen1.5-32b": "qwen1_5_32b",
    "deepseek-7b": "deepseek_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "grok-1-314b": "grok_1_314b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "zamba2-1.2b": "zamba2_1_2b",
    "xlstm-350m": "xlstm_350m",
    # the paper's own workloads (engine benchmarks)
    "paper-gpt3-large": "paper_gpt3_large",
}

ARCHS = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_archs() -> tuple[str, ...]:
    return ARCHS


def cut_depth(name: str, num_layers: int) -> ArchConfig:
    """The full-width config of ``name`` with its first ``num_layers``
    layers (its layer pattern cut to them): a model one card holds where
    the full depth does not (the MoE configs with their optimizer state,
    grok even for serving).  An enc-dec config is cut symmetrically: half
    the layers encoder, half decoder, as ``reduced_config`` does."""
    cfg = get_arch(name)
    pattern = (None if cfg.layer_pattern is None
               else cfg.layer_pattern[:num_layers])
    upd = {}
    if cfg.encoder_layers:
        upd["encoder_layers"] = num_layers // 2
    return dataclasses.replace(cfg, num_layers=num_layers,
                               layer_pattern=pattern, **upd)


def reduced_config(name: str, num_layers: int | None = None) -> ArchConfig:
    """Same-family tiny config for CPU smoke tests.

    Keeps the structural features (GQA ratio, layer pattern kind, MoE
    routing, pipeline pattern) while shrinking width/depth/vocab.
    """
    cfg = get_arch(name)
    layers = num_layers or max(4, len(cfg.layer_types()) * 2)
    # preserve the q/kv ratio
    nq = max(2, min(cfg.num_heads, 4))
    ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
    nkv = max(1, nq // min(ratio, nq))
    upd: dict = dict(
        num_layers=layers,
        d_model=64,
        num_heads=nq,
        num_kv_heads=nkv,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        dtype=torch.float32,
        layer_pattern=None,
    )
    if cfg.local_global_period:
        upd["local_global_period"] = 2
        upd["sliding_window"] = 8
    if cfg.encoder_layers:
        upd["encoder_layers"] = layers // 2
    if cfg.moe is not None:
        upd["moe"] = MoEConfig(
            num_experts=max(4, min(cfg.moe.num_experts, 8)),
            top_k=min(cfg.moe.top_k, 2),
            num_shared=min(cfg.moe.num_shared, 1),
            capacity_factor=2.0,
            dense_d_ff=96 if cfg.moe.dense_d_ff else 0,
        )
        upd["d_ff"] = 32
    if cfg.ssm is not None:
        upd["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16)
    if cfg.shared_attn_period:
        upd["shared_attn_period"] = 2
    if cfg.layer_pattern is not None and cfg.family == "ssm":
        # xlstm: keep the 7:1 idea at reduced scale -> 3:1
        upd["layer_pattern"] = tuple(
            "slstm" if (i + 1) % 4 == 0 else "mlstm" for i in range(layers)
        )
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **upd)
