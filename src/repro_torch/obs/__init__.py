"""Runtime observability: metrics, bubble attribution, Perfetto export,
online cost tables.

Layered strictly *on top of* the runtime (``repro_torch.runtime.rrfp`` never
imports this package except lazily from ``Trace.to_perfetto``):

  metrics     -- per-stage single-writer shards: counters, gauges,
                 log-bucketed histograms; aggregated at sync points
  cost_table  -- per-(stage, op) duration EWMAs -> CostModel snapshots
                 (the online input for ROADMAP item 3 hint re-synthesis)
  bubbles     -- idle-time decomposition over recorded traces: warmup,
                 dependency-wait, starvation, TP-gate, backpressure, drain
  critpath    -- critical-path engine: the execution DAG whose longest
                 path reconstructs the makespan exactly, with per-node
                 slack and a 100%-accounted category decomposition
  whatif      -- Coz-style causal what-if profiling: virtual speedups on
                 the critical-path graph predict the new makespan
  report      -- one-shot explain(trace) health report + CLI
  export      -- Chrome trace-event / Perfetto JSON rendering of traces
  spans       -- host spans of a training step on the perf_counter clock
                 (profiler ranges while a profiler runs) and the step
                 records they end in, with the tasks' own stamps

See ``docs/observability.md`` for the metric catalogue and semantics.
"""
from repro_torch.obs.bubbles import (
    CATEGORIES,
    BubbleReport,
    StageBubbles,
    compare,
    decompose,
    spec_from_meta,
)
from repro_torch.obs.cost_table import Ewma, OnlineCostTable
from repro_torch.obs.critpath import (
    CP_CATEGORIES,
    CritPathReport,
    ExecGraph,
)
from repro_torch.obs.export import export_perfetto, to_perfetto, validate_chrome_trace
from repro_torch.obs.metrics import (
    DEPTH_EDGES,
    DURATION_EDGES,
    Histogram,
    MetricsRegistry,
    StageShard,
    log_edges,
)
from repro_torch.obs.report import ExplainReport, explain
from repro_torch.obs.whatif import (
    Speedup,
    apply_to_cost_model,
    candidate_speedups,
    predict,
)

__all__ = [
    "BubbleReport",
    "CATEGORIES",
    "CP_CATEGORIES",
    "CritPathReport",
    "DEPTH_EDGES",
    "DURATION_EDGES",
    "Ewma",
    "ExecGraph",
    "ExplainReport",
    "Histogram",
    "MetricsRegistry",
    "OnlineCostTable",
    "Speedup",
    "StageBubbles",
    "StageShard",
    "apply_to_cost_model",
    "candidate_speedups",
    "compare",
    "decompose",
    "explain",
    "export_perfetto",
    "log_edges",
    "predict",
    "spec_from_meta",
    "to_perfetto",
    "validate_chrome_trace",
]
