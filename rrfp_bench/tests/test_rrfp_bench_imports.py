"""What the benchmark runs imports neither JAX nor the JAX package
(``repro``, compared by whole top-level name: ``repro_torch`` is the
program), nor anything of ``benchmarks/``; the reference, the yardstick
and the model families import nothing of the program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "rrfp_bench"
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_banned_top_level_import(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize("part", ["reference", "yardstick", "families"])
def test_reference_and_yardstick_import_nothing_of_the_program(part):
    for path in (BENCH / part).rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_a_run_loads_no_jax_in_its_process():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import rrfp_bench.run, rrfp_bench.calibrate\n"
            "from rrfp_bench.harness import cell, program\n"
            "from repro_torch.launch import train\n"
            "print(cell.forbidden_modules())\n" % (str(ROOT),
                                                     str(ROOT / "src")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_exits_without_a_result(tmp_path):
    """Here there is no CUDA card; and a directory holding only
    BENCHMARK.json and the benchmark's files has no program either."""
    import shutil

    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would start")
    (tmp_path / "rrfp_bench").mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH.rglob("*"):
        if p.is_file() and ".cache" not in p.parts and (
                "__pycache__" not in p.parts):
            dst = tmp_path / p.relative_to(ROOT)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(p, dst)
    name = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "rrfp_bench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
