"""The table runtime on a mesh of processes (``launch/procs.py``) against the
thread mesh, gloo on the CPU, one intra-op thread on both sides.

* ``launch.train.build_trainer(mesh=...)`` on reduced paper-gpt3-large
  (4 layers, seq 16, 4 microbatches of 2 rows a data rank), on 1 x 2 and
  2 x 2 meshes of processes, under 1f1b and zb for 2 steps: losses,
  gnorms, every rank's parameters and ZeRO-1 state bitwise the thread
  mesh's;
* reduced deepseek-moe-16b (4 layers, 2 stages) on 2 x 2 under the ``ep``
  (16 experts) and ``tp`` (8) layouts, the same;
* ``train.main([... "--runtime", "table", "--procs", "--device", "cpu"])``:
  rank 0's losses and gnorms bitwise the thread run's of the same command,
  the same collectives a step summed over the ranks, every rank's report
  back and the data replicas' digests equal; the actor-runtime flags stop
  before a world starts (checkpoints: ``tests/test_torch_procs_ckpt.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import mesh_probes, train
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.procs import spawn_world

DEADLINE = 60.0
GPT3 = dict(arch="paper-gpt3-large", layers=4, mb_rows=2, microbatches=4,
            seq=16)
STEPS = 2


def _moe_cfg(experts: int):
    cfg = registry.reduced_config("deepseek-moe-16b", num_layers=4)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=experts))


#: each world (a mesh and its programs) is spawned once; the 2 x 2 mesh's
#: programs in two worlds, so that each stays well inside its deadline
WORLDS = {
    "1x2 gpt3": (1, [(f"gpt3 {s}", "trainer", (
        {**GPT3, "data": 1, "stages": 2, "schedule": s}, STEPS))
        for s in ("1f1b", "zb")]),
    "2x2 gpt3": (2, [(f"gpt3 {s}", "trainer", (
        {**GPT3, "data": 2, "stages": 2, "schedule": s}, STEPS))
        for s in ("1f1b", "zb")]),
    "2x2 moe": (2, [(f"moe {layout}", "trainer", (
        dict(arch="deepseek-moe-16b", layers=4, mb_rows=1, microbatches=2,
             seq=16, data=2, stages=2, schedule="1f1b",
             cfg=_moe_cfg(experts)), STEPS))
        for layout, experts in (("ep", 16), ("tp", 8))]),
}


@pytest.fixture(scope="module")
def worlds():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, (data, calls) in WORLDS.items():
            shape = {"data": data, "model": 2}
            procs = mesh_probes.merge(spawn_world(
                mesh_probes.several, (calls,), 2 * data, shape=shape,
                device="cpu", deadline=DEADLINE, threads=1))
            threads = mesh_probes.several(Mesh(shape, device="cpu"), calls)
            out[name] = (procs, threads)
        return out
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("world,label", [
    (w, c[0]) for w, (_, calls) in WORLDS.items() for c in calls])
def test_a_trainer_of_processes_gives_the_thread_meshs_bits(worlds, world,
                                                            label):
    procs, threads = worlds[world]
    assert sorted(procs) == sorted(threads) == list(
        range(2 * WORLDS[world][0]))
    for r in threads:
        mesh_probes.check_same_bits(procs[r][label], threads[r][label],
                                    f"rank {r}")
    got = procs[0][label]
    assert len(got["losses"]) == STEPS
    assert all(np.isfinite(got["losses"] + got["gnorms"]))
    # every rank holds the same reduced loss and gnorm
    assert all(procs[r][label]["losses"] == got["losses"] for r in procs)


def test_the_moe_layouts_shard_the_experts_over_the_data_ranks(worlds):
    procs, _ = worlds["2x2 moe"]
    for label in ("moe ep", "moe tp"):
        experts = procs[0][label]["opt_state"]["experts"]
        assert experts, label
        # the data ranks' expert state: shards, not copies
        other = procs[2][label]["opt_state"]["experts"]
        k = next(iter(experts))
        assert not torch.equal(experts[k]["m"], other[k]["m"]), label


CLI = ["--runtime", "table", "--device", "cpu", "--arch",
       "paper-gpt3-large", "--devices", "4", "--stages", "2", "--layers",
       "4", "--microbatches", "4", "--seq", "16", "--steps", "2",
       "--schedule", "1f1b"]


def test_the_cli_with_procs_gives_the_thread_runs_bits():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        procs = train.main(CLI + ["--procs"])
        threads = train.main(CLI)
    finally:
        torch.set_num_threads(n)
    assert procs.losses == threads.losses
    assert procs.gnorms == threads.gnorms
    assert ([{k: n for k, (n, _) in c.items()} for c in procs.collectives]
            == [{k: n for k, (n, _) in c.items()}
                for c in threads.collectives])
    assert procs.trainer is None and len(procs.ranks) == 4
    assert [r["rank"] for r in procs.ranks] == [0, 1, 2, 3]
    for r in procs.ranks:
        twin = procs.ranks[r["coords"]["model"]]  # data index 0
        assert r["digests"] == twin["digests"]
        assert r["peak_bytes"] == 0  # the CPU: no device memory


@pytest.mark.parametrize("extra,match", [
    (["--adaptive"], "--adaptive under --procs: an actor-runtime flag"),
    (["--recover"], "--recover under --procs: an actor-runtime flag"),
    (["--chaos", "C1"], "--chaos under --procs"),
    (["--dist-backend", "nccl"], "--device cpu takes gloo"),
])
def test_flags_that_do_not_run_over_processes_stop(extra, match):
    with pytest.raises(SystemExit, match=match):
        train.main(CLI + ["--procs"] + extra)


def test_dist_backend_without_procs_stops():
    with pytest.raises(SystemExit, match="backend of --procs"):
        train.main(CLI + ["--dist-backend", "gloo"])
    with pytest.raises(SystemExit, match="--runtime table"):
        train.main([a for a in CLI if a not in ("--runtime", "table")]
                   + ["--procs"])


def test_processes_started_by_hand_join_the_world_their_variables_set(
        tmp_path):
    """What ``torchrun`` does: two processes of ``python -m
    repro_torch.launch.train ... --procs`` with ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` set (and a ``file://`` store for the address) each
    run their own rank of a 1 x 2 mesh; rank 0 prints the steps, and its
    losses are the thread run's."""
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.launch.procs import INIT_METHOD_ENV

    argv = list(CLI)
    argv[argv.index("--devices") + 1] = "2"
    src = str(Path(__file__).resolve().parents[1] / "src")
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=src, **{INIT_METHOD_ENV: "file://" + str(
                       tmp_path / "store")})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv,
             "--procs"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    steps = [re.findall(r"step +\d+ +loss +([-\d.]+)", o) for o in outs]
    assert len(steps[0]) == 2 and steps[1] == []
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        threads = train.main(argv)
    finally:
        torch.set_num_threads(n)
    assert [float(x) for x in steps[0]] == [
        float(f"{v:.4f}") for v in threads.losses]
