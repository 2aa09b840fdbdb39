"""Grok-1 (314B) — MoE 8 experts top-2, GQA kv=8.  [hf:xai-org/grok-1;
unverified]  Expert layout: TP on d_ff over the data axis (8 experts < 16
devices), DESIGN §3."""
import torch
from repro_torch.models.common import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    act="geglu",
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    dtype=torch.bfloat16,
)
