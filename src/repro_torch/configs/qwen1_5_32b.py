"""Qwen1.5-32B — dense with QKV bias.  [hf:Qwen/Qwen1.5 family; hf]"""
import torch
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,      # full MHA
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)
