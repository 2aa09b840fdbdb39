"""A cell of the benchmark cut to a size a CPU test run holds: the same
code paths (program and reference) at toy widths."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from rrfp_bench.harness import manifest

ROOT = Path(__file__).resolve().parents[2]
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
    """(cell, program config) of workload ``name`` at the toy cut of its
    family (``small``), in ``dtype``."""
    from repro_torch.configs import registry

    cell = any_cell(name)
    c, upd, traffic = manifest.family(cell.config).small(
        dict(cell.config, dtype=dtype))
    base = registry.get_arch(c["arch"])
    upd = {k: dataclasses.replace(getattr(base, k), **v)
           if isinstance(v, dict) else v for k, v in upd.items()}
    cfg = dataclasses.replace(base, dtype=getattr(torch, dtype), **upd)
    cell.config = c
    cell.traffic = dict(cell.traffic, **traffic)
    return cell, cfg
