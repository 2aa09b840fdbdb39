"""Qwen2-VL-2B backbone — M-RoPE, dynamic resolution (vision frontend stubbed:
input_specs provides patch+text embeddings and 3-axis position ids).
[arXiv:2409.12191; hf]"""
import torch
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mrope=True,
    rope_theta=1_000_000.0,
    embed_input=True,       # frontend stub supplies embeddings
    dtype=torch.bfloat16,
)
