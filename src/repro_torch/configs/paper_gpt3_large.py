"""GPT3-Large — the paper's LLM workload (engine benchmarks; RQ1).
[arXiv:2005.14165]"""
import torch
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="paper-gpt3-large",
    family="dense",
    num_layers=24,
    d_model=1536,
    num_heads=16,
    num_kv_heads=16,
    d_ff=6144,
    vocab_size=50304,
    act="gelu",
    dtype=torch.bfloat16,
)
