"""Gemma3-4B — dense, 5:1 local:global attention, 128k context, 262k vocab.
[hf:google/gemma-3-1b-pt family; unverified]"""
import torch
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,          # gemma3 uses explicit head_dim
    rope_theta=1_000_000.0,
    sliding_window=1024,   # local layers' window
    local_global_period=6, # every 6th layer global (5 local : 1 global)
    act="geglu",
    dtype=torch.bfloat16,
    sub_quadratic=True,    # 5:1 local:global -> long_500k eligible (DESIGN §4)
)
