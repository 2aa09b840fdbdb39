"""Heterogeneous multimodal pipelines on the readiness-driven runtime
(PyTorch port of ``repro.multimodal``).

The paper's headline (up to 2.77×) result is multimodal: cheap,
variable-length vision-encoder stages misaligned with LM-decoder stages —
the regime where consuming the schedule as a non-binding hint pays most.
This package makes that regime executable end to end:

  model    -- branch+fusion DAG topology (encoder branch ∥ text frontend →
              fusion → LM chain) with real per-stage parameters built from
              ``models/layers.py``; encoder math at the fixed inner length
  stagefn  -- per-(stage, op) callables (autograd, F without it) + the
              actor-runtime ``work_fn`` adapter handling DAG fan-in/fan-out
              payloads, BFW split backward and deterministic reduction
  costs    -- DES cost models of the same topologies for the simulation
              substrate and the multimodal benchmark

See ``docs/multimodal.md`` for the DAG task-graph semantics.
"""
from repro_torch.multimodal.costs import multimodal_dag_costs
from repro_torch.multimodal.model import (
    MULTIMODAL_ARCHS,
    MultimodalConfig,
    MultimodalModel,
    multimodal_config,
    multimodal_model,
)
from repro_torch.multimodal.stagefn import (
    MultimodalStageFns,
    MultimodalStageProgram,
)

__all__ = [
    "MULTIMODAL_ARCHS",
    "MultimodalConfig",
    "MultimodalModel",
    "MultimodalStageFns",
    "MultimodalStageProgram",
    "multimodal_config",
    "multimodal_dag_costs",
    "multimodal_model",
]
