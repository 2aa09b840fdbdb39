"""Zamba2-1.2B — Mamba2 backbone with a shared attention block invoked every
6 layers.  [arXiv:2411.15242; hf]  Runs long_500k (SSM decode state is O(1)
in sequence length)."""
import torch
from repro_torch.models.common import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,              # shared block FFN
    vocab_size=32000,
    head_dim=64,
    layer_pattern=tuple("mamba" for _ in range(38)),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=64),
    shared_attn_period=6,
    dtype=torch.bfloat16,
    sub_quadratic=True,
)
