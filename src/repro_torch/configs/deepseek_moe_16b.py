"""DeepSeekMoE-16B — fine-grained 64 routed experts top-6 + 2 shared, first
layer dense (d_ff 10944).  [arXiv:2401.06066; hf]  Expert layout: true EP
(4 experts/device over the data axis), DESIGN §3."""
import torch
from repro_torch.models.common import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,              # moe_intermediate_size
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2,
                  capacity_factor=1.0, dense_d_ff=10944),   # §Perf: cf 1.25->1.0
    dtype=torch.bfloat16,
)
