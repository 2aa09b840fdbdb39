"""xLSTM-350M — sLSTM + mLSTM blocks, xLSTM[7:1] layer ratio.
[arXiv:2405.04517; unverified]  Runs long_500k (recurrent state)."""
import torch
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                # xLSTM blocks carry their own projections
    vocab_size=50304,
    layer_pattern=tuple(
        "slstm" if (i + 1) % 8 == 0 else "mlstm" for i in range(24)
    ),
    dtype=torch.bfloat16,
    sub_quadratic=True,
)
