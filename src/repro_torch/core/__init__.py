"""RRFP core: readiness-driven pipeline runtime (the paper's contribution).

Layering (bottom-up):
  taskgraph -- dependency-constrained task model (§3.1)
  costs     -- runtime-variability models (§2, RQ4 injection)
  hints     -- hint orders Π + fixed pre-committed orders (§5, App. A)
  engine    -- message-driven, ready-set-arbitrated event runtime (§4, App. C/D)
  bounds    -- Theorem 6.1 / Corollary 6.2 / Fig. 6 analysis (§6, App. B)
  synthesis -- engine -> static schedule table for the compiled executor
"""
from repro_torch.core.costs import (
    CostModel,
    InjectionModel,
    INJECTION_LEVELS,
    JitterModel,
    multimodal_stage_flops,
)
from repro_torch.core.engine import (
    DeadlockError,
    Engine,
    EngineConfig,
    RunResult,
    average_makespan,
    run_iteration,
)
from repro_torch.core.hints import HintArbiter, HintKind, ReadySet
from repro_torch.core.synthesis import SynthesisResult, ema_update_costs, synthesize
from repro_torch.core.taskgraph import Kind, PipelineSpec, StageGraph, Task

__all__ = [
    "CostModel", "InjectionModel", "INJECTION_LEVELS", "JitterModel",
    "multimodal_stage_flops", "DeadlockError", "Engine", "EngineConfig",
    "RunResult", "average_makespan", "run_iteration", "HintArbiter",
    "HintKind", "ReadySet", "SynthesisResult", "ema_update_costs",
    "synthesize",
    "Kind", "PipelineSpec", "StageGraph", "Task",
]
