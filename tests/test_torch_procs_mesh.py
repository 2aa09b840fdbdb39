"""The mesh over ``torch.distributed`` (``repro_torch.launch.procs``), one
process per rank, against the in-process thread mesh, gloo on the CPU.

Each world is spawned once (``procs.spawn_world``, a ``file://`` store in a
temporary directory, at most 60 s, one intra-op thread a process) and
carries several world programs of ``launch/mesh_probes.py``; the thread
mesh runs the same programs here, with one intra-op thread too (the bits
of a CPU GEMM may depend on the count), and every result must be the same
bits:

* on 2 x 2 and on 2 x 1 x 2 (``pod``): every collective over every
  ordered axis tuple (``("model", "data")`` and ``("data", "pod")``
  among them), in float32 and bfloat16: ``ppermute`` (tensors and
  ``(tensor, int, bool)`` tuples, zero-filled where no rank sends),
  ``psum``, ``pmax``, ``psum_scatter``, ``all_gather`` tiled and stacked,
  ``all_to_all`` and ``axis_group``;
* on 2 x 2: ``pipeline.decode.make_serve_fn`` under ``sp_mode`` (reduced
  gemma3), with the batch over the data ranks (reduced deepseek-7b) and
  the MoE ``ep`` layout at decode (reduced deepseek-moe, 16 experts):
  tokens, last hidden states and caches;
* a rank that skips a collective, ranks that call different ones, a
  collective inside an autograd backward each raise ``CollectiveError``; a
  rank that raises makes the parent raise its error, naming it; a rank
  that outlives the world's deadline is killed and the parent raises.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh_probes
from repro_torch.launch.mesh import CollectiveError, Mesh, make_mesh
from repro_torch.launch.procs import (
    ProcessMesh,
    WorldError,
    _decode,
    _encode,
    check_backend,
    spawn_world,
)

DEADLINE = 60.0
SHAPES = {"2x2": {"data": 2, "model": 2},
          "pod": {"pod": 2, "data": 1, "model": 2}}
COLLECTIVES = [("collectives float32", "collectives", (0, "float32")),
               ("collectives bfloat16", "collectives", (1, "bfloat16"))]
SERVES = [(f"serve {tag}", "serve", (tag,)) for tag in mesh_probes.SERVE_CASES]
CALLS = {"2x2": COLLECTIVES + SERVES, "pod": COLLECTIVES}


def _spawn(fn, args, shape, **kw):
    n = int(np.prod(list(shape.values())))
    return mesh_probes.merge(spawn_world(
        fn, args, n, shape=shape, device="cpu", deadline=DEADLINE,
        threads=1, **kw))


@pytest.fixture(scope="module")
def worlds():
    """Each mesh's programs, in its world of processes and on the thread
    mesh (one intra-op thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, shape in SHAPES.items():
            procs = _spawn(mesh_probes.several, (CALLS[name],), shape)
            threads = mesh_probes.several(
                Mesh(shape, device="cpu"), CALLS[name])
            out[name] = (procs, threads)
        return out
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("mesh,label", [
    (m, c[0]) for m in SHAPES for c in CALLS[m]])
def test_a_world_of_processes_gives_the_thread_meshs_bits(worlds, mesh,
                                                          label):
    procs, threads = worlds[mesh]
    assert sorted(procs) == sorted(threads) == list(range(4))
    for r in threads:
        mesh_probes.check_same_bits(procs[r][label], threads[r][label],
                                    f"rank {r}")


def test_the_probe_reaches_every_collective_and_the_zero_fill(worlds):
    procs, _ = worlds["2x2"]
    got = procs[0]["collectives float32"]
    assert {"model", "data", "data/model", "model/data"} <= set(got)
    assert set(got["model/data"]) == {
        "psum", "pmax", "psum_scatter", "all_gather", "all_gather_stacked",
        "all_to_all", "axis_group", "psum_scalar"}
    # rank 0 is model index 0: nothing reaches it on the forward ring
    t, mb, valid = got["ppermute/model/forward/tuple"]
    assert (mb, valid) == (0, False) and not t.any()
    # rank 1 (model index 1) receives rank 0's (2x, 10 * 0 + 0, True)
    t, mb, valid = procs[1]["collectives float32"][
        "ppermute/model/forward/tuple"]
    assert (type(mb), mb, type(valid), valid) == (int, 0, bool, True)
    # ("model", "data") indexes members otherwise than ascending rank
    assert procs[1]["collectives float32"]["model/data"]["axis_group"][
        :2] == (2, 4)


def test_the_pod_mesh_groups_pod_with_data(worlds):
    procs, _ = worlds["pod"]
    got = procs[3]["collectives bfloat16"]
    assert {"pod/data", "data/pod", "pod/data/model",
            "model/pod/data"} <= set(got)
    assert got["pod/data"]["psum"].dtype == torch.bfloat16


def _fault(case, wait=0.0, timeout=3.0, deadline=DEADLINE):
    t0 = time.monotonic()
    try:
        spawn_world(mesh_probes.faults, (case, wait), 2,
                    shape={"data": 1, "model": 2}, device="cpu",
                    timeout=timeout, deadline=deadline, threads=1)
    finally:
        elapsed = time.monotonic() - t0
        assert elapsed < 45, elapsed


def test_a_rank_that_skips_a_collective_raises_within_the_timeout():
    with pytest.raises(CollectiveError, match=r"rank 0 .*pmax over model "
                       r"timed out after 3 s"):
        _fault("skip", wait=6.0)


def test_ranks_that_call_different_collectives_raise():
    with pytest.raises(CollectiveError, match=r"different collectives "
                       r"\['all_to_all', 'psum_scatter'\]"):
        _fault("mismatch")


def test_a_collective_inside_a_backward_raises():
    with pytest.raises(CollectiveError, match="inside an autograd backward"):
        _fault("backward", timeout=30.0)


def test_a_rank_that_raises_is_reraised_by_the_parent_naming_it():
    with pytest.raises(ValueError, match="rank 1 fails") as e:
        _fault("raise", timeout=30.0)
    notes = "\n".join(getattr(e.value, "__notes__", []))
    assert "in rank 1 {'data': 0, 'model': 1}" in notes
    assert "raised by rank 1 of the spawned world" in notes
    assert "Traceback" in notes


def test_a_rank_past_the_deadline_is_killed_and_the_parent_raises():
    # rank 0 hangs; rank 1 returns, unless a loaded machine has not yet
    # started it by the deadline
    with pytest.raises(WorldError, match=r"rank\(s\) \[0(, 1)?\] of a world "
                       r"of 2 still ran after the deadline of 8 s: killed"):
        _fault("hang", wait=40.0, deadline=8.0)


def test_the_header_round_trips_payloads_and_host_scalars():
    t = torch.zeros(3, 1, 7, dtype=torch.bfloat16)
    assert _decode(_encode("ppermute", (t, 5, True))) == (
        "ppermute", ((torch.bfloat16, (3, 1, 7)), 5, True))
    assert _decode(_encode("psum", torch.zeros(()))) == (
        "psum", ((torch.float32, ()),))
    with pytest.raises(TypeError, match="float"):
        _encode("ppermute", (t, 0.5))


def test_nccl_stops_before_the_world_starts():
    cards = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=rf"{cards + 1} ranks on {cards} "
                       r"card\(s\): NCCL puts no two ranks"):
        check_backend("nccl", "cuda", cards + 1)
    with pytest.raises(SystemExit, match="--device cpu takes gloo"):
        check_backend("nccl", "cpu", 1)
    with pytest.raises(SystemExit, match="one of"):
        check_backend("mpi", "cpu", 1)


def test_a_process_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="no torch.distributed world"):
        ProcessMesh({"data": 1, "model": 2}, device="cpu")


def test_local_ranks_and_per_rank_of_the_thread_mesh():
    mesh = make_mesh(2, 2, device="cpu")
    assert mesh.local_ranks == (0, 1, 2, 3)
    assert mesh.per_rank(lambda r: r * 10) == [0, 10, 20, 30]
    assert mesh.group_members(("model", "data"), 3) == (0, 1, 2, 3)
    assert mesh.group_members("data", 3) == (1, 3)
