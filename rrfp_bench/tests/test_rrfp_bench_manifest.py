"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it resolves to its file."""
import json
import re
from pathlib import Path

import pytest

from rrfp_bench.harness import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == TOP
    assert BENCH["command"][:2] == ["python3", "rrfp_bench/run.py"]
    assert BENCH["paths"] == ["rrfp_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    # a full check of 24 cells fits its time
    n = 24
    total = ((2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90
             + 1200)
    assert total <= 43200


def test_names_units_and_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for section, want in keys.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(set(names)) == len(names)
        for e in BENCH[section]:
            assert set(e) == want, e
            assert NAME.match(e["name"]) and _one_line(e["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in names


def test_per_layer_metrics_move_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_resolves_to_its_files():
    for w in BENCH["workloads"]:
        cell = manifest.cell(ROOT, w["name"])
        assert cell.chips in (1, 4)
        assert cell.end_to_end and cell.per_layer
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for key in ("loss_gap", "grad_gap", "change_gap"):
            assert cell.limits[key] > 0
        for key in ("runtime", "hint", "stages", "microbatches", "mb_rows",
                    "seq", "split_backward", "w_defer_cap", "trace_steps"):
            assert key in cell.traffic
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("rrfp_bench/") and path.is_file()
        config = json.loads(path.read_text())
        assert config["name"] == c["name"]
        assert callable(manifest.family(config).Reference)
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    assert callable(manifest.reader(metric))


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
