"""Model zoo in PyTorch: the dense decoder slice of the reference models."""
from repro_torch.models.build import ArchModel, build
from repro_torch.models.common import ArchConfig, MoEConfig, SHAPES, SSMConfig, ShapeCell
