"""Assigned architecture configs (exact, from public literature) + the
paper's own workloads.  Select with --arch <id> via repro_torch.configs.registry."""
from repro_torch.configs.registry import ARCHS, get_arch, list_archs, reduced_config
