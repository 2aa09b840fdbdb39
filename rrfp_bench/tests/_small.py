"""A cell of the benchmark cut to a size a CPU test run holds: the same
code paths (program and reference) at toy widths."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from rrfp_bench.harness import manifest

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
             head_dim=16, vocab_size=256)
#: cells whose files the benchmark keeps but does not run until the
#: program's token embedding is repaired: workload -> (config, traffic)
HELD = {"gpt3-rrfp-bf": ("paper-gpt3-large", "bf-32x2048"),
        "moe-rrfp-bf": ("deepseek-moe-16b-l4", "bf-8x4096"),
        "gpt3-rrfp-bfw": ("paper-gpt3-large", "bfw-32x2048")}
CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]] + list(HELD)


def any_cell(name: str) -> manifest.Cell:
    """Workload ``name`` of ``BENCHMARK.json``, or a held cell from its
    files."""
    if name not in HELD:
        return manifest.cell(ROOT, name)
    config, traffic = HELD[name]
    bench = manifest.load(ROOT)
    read = lambda *p: json.loads(ROOT.joinpath("rrfp_bench", *p)
                                 .read_text())
    return manifest.Cell(name, read("configs", f"{config}.json"),
                         read("traffic", f"{traffic}.json"), 1,
                         read("limits", f"{name}.json"), bench["end_to_end"],
                         [m for m in bench["per_layer"]
                          if "workloads" not in m])


def small_cell(name: str, dtype: str = "float32"):
    """(cell, program config) of workload ``name`` at toy widths: 4 layers
    of d 64, 2 stages, 4 microbatches of 32 tokens."""
    from repro_torch.configs import registry
    from repro_torch.models.common import MoEConfig

    cell = any_cell(name)
    c = dict(cell.config, **SMALL, dtype=dtype)
    upd = dict(SMALL, dtype=getattr(torch, dtype), layer_pattern=None)
    if c.get("moe"):
        c["d_ff"] = upd["d_ff"] = 32
        c["moe"] = dict(c["moe"], num_experts=8, top_k=2, num_shared=1,
                        dense_d_ff=96)
        m = c["moe"]
        upd["moe"] = MoEConfig(num_experts=8, top_k=2, num_shared=1,
                               capacity_factor=m["capacity_factor"],
                               dense_d_ff=96)
    else:
        c["d_ff"] = upd["d_ff"] = 128
    if c.get("mrope_section"):
        # grouped queries kept; M-RoPE's sections cut to head_dim 16 as
        # the program cuts them
        c["num_kv_heads"] = upd["num_kv_heads"] = 2
        c["mrope_section"] = [2, 3, 3]
    cfg = dataclasses.replace(registry.get_arch(c["arch"]), **upd)
    cell.config = c
    cell.traffic = dict(cell.traffic, stages=2, microbatches=4,
                        mb_rows=1 if c.get("moe") else 2, seq=32,
                        trace_steps=1)
    return cell, cfg
