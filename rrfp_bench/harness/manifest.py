"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the file its entry names, and its model is the family
module ``rrfp_bench/families/<family>.py`` that the file names under
``"family"``; a traffic mix is ``rrfp_bench/traffic/<traffic>.json``; a
cell's limits for ``correct`` are ``rrfp_bench/limits/<workload>.json``
(each beside the manifest that names it); a metric, end-to-end or
per-layer, is read by ``rrfp_bench/metrics/<name>.py``'s ``read(ctx)``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str) -> Cell:
    """Workload ``name`` of the manifest at ``root``, its files read."""
    bench = load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {sorted(by_name)})")
    w = by_name[name]
    conf = {cf["name"]: cf for cf in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    if "family" not in config:
        raise SystemExit(f"{conf['file']} names no model family: it needs "
                         f"\"family\", a module of rrfp_bench/families/")
    family(config)
    files = root / "rrfp_bench"
    traffic = json.loads((files / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((files / "limits" / f"{name}.json").read_text())
    return Cell(name, config, traffic, w["chips"], limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"rrfp_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(c: dict):
    """The module ``rrfp_bench/families/<family>.py`` that configuration
    ``c`` names: its model (the interface: :mod:`rrfp_bench.families`)."""
    name = c.get("family")
    if not isinstance(name, str) or not name.isidentifier():
        raise SystemExit(f"configuration {c.get('name')!r} names no model "
                         f"family: \"family\" has to name a module of "
                         f"rrfp_bench/families/, not {name!r}")
    module = f"rrfp_bench.families.{name}"
    if importlib.util.find_spec(module) is None:
        raise SystemExit(f"configuration {c.get('name')!r} names family "
                         f"{name!r}: there is no rrfp_bench/families/"
                         f"{name}.py")
    return importlib.import_module(module)
