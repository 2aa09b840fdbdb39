"""DeepSeek-7B — dense llama-arch.  [arXiv:2401.02954; hf]"""
import torch
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
)
