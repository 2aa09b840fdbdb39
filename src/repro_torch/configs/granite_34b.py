"""Granite-34B (code) — dense llama-arch, 88L, GQA kv=1 (MQA).
[arXiv:2405.04324; hf]"""
import torch
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,       # MQA
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=10_000.0,
    act="gelu",            # gpt_bigcode-style 2-matrix FFN (-> ~34B total)
    dtype=torch.bfloat16,
)
