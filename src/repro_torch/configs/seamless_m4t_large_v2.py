"""SeamlessM4T-large-v2 — encoder-decoder multimodal (audio frontend stubbed:
input_specs provides precomputed frame embeddings).  [arXiv:2308.11596; hf]

24 encoder + 24 decoder layers (the assigned 24L spec applied to both halves
of the enc-dec stack, mirroring the HF config's symmetric layout)."""
import torch
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=48,          # 24 enc + 24 dec
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    embed_input=False,      # decoder tokens are embedded; enc frames stubbed
    dtype=torch.bfloat16,
)
