"""Table checkpoints and ``--resume`` on a mesh of processes
(``launch/train.py --runtime table --procs``) against the thread mesh, gloo
on the CPU, one intra-op thread on both sides.

* reduced paper-gpt3-large (4 layers, seq 16, 1f1b) on 1 x 2 and 2 x 2,
  and reduced deepseek-moe-16b (4 layers, 2 stages) on 2 x 2 under ``ep``
  (16 experts) and ``tp`` (8): the step-2 checkpoint of ``--procs`` (every
  rank's state gathered through rank 0's host) equals the thread mesh's of
  the same command: one shard, the same manifest leaves, shapes, dtypes
  and ``np.array_equal`` values;
* ``--procs --steps 3 --ckpt-every 2`` (uninterrupted, saving at step 2
  while step 2 runs) then ``--procs --steps 3 --resume``: step 2's loss
  and gnorm bitwise the uninterrupted ``--procs`` run's and the thread
  run's; a thread checkpoint resumed under ``--procs`` and a ``--procs``
  checkpoint resumed on threads, both bitwise;
* failures: an unwritable ``--ckpt-dir``, a write that fails on rank 0 and
  a leaf missing at restore each make the parent raise rank 0's error
  (its rank and traceback in the notes), no ``LATEST`` names a step that
  did not land, and nothing hangs;
* ``ProcessMesh.move`` and ``share``, the host transfers underneath: their
  results, and a ``CollectiveError`` on every rank where the ranks disagree.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import mesh_probes, train
from repro_torch.launch.procs import spawn_world

DEADLINE = 60.0
GPT3 = ["--runtime", "table", "--device", "cpu", "--arch",
        "paper-gpt3-large", "--stages", "2", "--layers", "4",
        "--microbatches", "4", "--seq", "16", "--schedule", "1f1b"]
MOE = ["--runtime", "table", "--device", "cpu", "--arch",
       "deepseek-moe-16b", "--devices", "4", "--stages", "2", "--layers",
       "4", "--microbatches", "2", "--seq", "16", "--schedule", "1f1b"]


def _moe_cfg(experts: int):
    cfg = registry.reduced_config("deepseek-moe-16b", num_layers=4)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=experts))


def _args(argv):
    args = train.parser().parse_args(argv)
    train._check_procs_flags(args)
    train._check_table_flags(args)
    train._check_flags(args)
    return args


def _procs(argv, cfg=None) -> train.TrainRun:
    """``train.main(argv + ["--procs"])`` (``train_table(args, cfg=cfg)``)
    as ``train_procs`` spawns it, with one thread a process and a
    deadline."""
    args = _args(argv + ["--procs"])
    shape = {"data": args.devices // args.stages, "model": args.stages}
    runs = spawn_world(train._train_world, (args, cfg), args.devices,
                       shape=shape, device="cpu", deadline=DEADLINE,
                       threads=1)
    run = runs[0]
    run.ranks = [r.ranks[0] for r in runs]
    return run


def _threads(argv, cfg=None) -> train.TrainRun:
    return train.train_table(_args(argv), cfg=cfg)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_checkpoint(a, b) -> None:
    """Two checkpoint directories' step 2: manifests with the same leaves
    and one shard, every leaf's dtype, shape and values equal."""
    ma = json.loads((a / "step_2" / "manifest.json").read_text())
    mb = json.loads((b / "step_2" / "manifest.json").read_text())
    assert ma["leaves"] == mb["leaves"] and ma["shards"] == mb["shards"] == 1
    assert (a / "LATEST").read_text() == (b / "LATEST").read_text() == "2"
    with np.load(a / "step_2" / "shard_0.npz") as x, \
            np.load(b / "step_2" / "shard_0.npz") as y:
        assert sorted(x.files) == sorted(y.files) == sorted(ma["leaves"])
        for k in ma["leaves"]:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            assert np.array_equal(x[k], y[k]), k


@pytest.fixture(scope="module")
def gpt3_2x2(tmp_path_factory):
    """gpt3 on 2 x 2, 3 steps saving at step 2 (``--ckpt-every 2``), on
    both meshes: the uninterrupted runs and their step-2 checkpoints."""
    d = tmp_path_factory.mktemp("procs_ckpt")
    argv = GPT3 + ["--devices", "4"]
    save = ["--steps", "3", "--ckpt-every", "2", "--ckpt-dir"]
    whole = _procs(argv + save + [str(d / "p")])
    threads = _threads(argv + save + [str(d / "t")])
    return argv, d, whole, threads


CASES = {
    "gpt3 1x2": (GPT3 + ["--devices", "2"], None),
    "gpt3 2x2": None,  # the gpt3_2x2 fixture's
    "moe ep 2x2": (MOE, 16),
    "moe tp 2x2": (MOE, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_procs_checkpoint_is_the_thread_meshs(case, tmp_path, request):
    if CASES[case] is None:
        _, tmp_path, procs, threads = request.getfixturevalue("gpt3_2x2")
        experts = None
    else:
        argv, experts = CASES[case]
        cfg = None if experts is None else _moe_cfg(experts)
        save = ["--steps", "2", "--ckpt-every", "2", "--ckpt-dir"]
        procs = _procs(argv + save + [str(tmp_path / "p")], cfg)
        threads = _threads(argv + save + [str(tmp_path / "t")], cfg)
    assert procs.losses == threads.losses and procs.gnorms == threads.gnorms
    _same_checkpoint(tmp_path / "p", tmp_path / "t")
    (entry,) = procs.ckpt_log
    assert entry["op"] == "save" and entry["step"] == 2
    assert entry["bytes"] == threads.ckpt_log[0]["bytes"] > 0
    assert entry["gather_seconds"] > 0 and entry["write_seconds"] > 0
    if experts is not None:
        assert threads.trainer["model"].moe_layout == (
            "ep" if experts == 16 else "tp")


def _resumed(run, whole, threads) -> None:
    assert run.ckpt_log[0]["op"] == "resume" and run.ckpt_log[0]["step"] == 2
    assert run.losses == whole.losses[2:] == threads.losses[2:]
    assert run.gnorms == whole.gnorms[2:] == threads.gnorms[2:]


def test_a_procs_resume_continues_bit_for_bit(gpt3_2x2):
    argv, d, whole, threads = gpt3_2x2
    assert whole.losses == threads.losses and whole.gnorms == threads.gnorms
    resumed = train.main(argv + ["--steps", "3", "--procs", "--ckpt-dir",
                                 str(d / "p"), "--resume"])
    _resumed(resumed, whole, threads)
    assert len(resumed.ranks) == 4
    assert all(r["peak_rss_bytes"] > 0 for r in resumed.ranks)
    assert resumed.ckpt_log[0]["peak_rss_bytes"] > 0


@pytest.mark.parametrize("writer,reader", [("t", "procs"),
                                           ("p", "threads")])
def test_checkpoints_cross_between_the_meshes(gpt3_2x2, writer, reader):
    argv, d, whole, threads = gpt3_2x2
    resume = argv + ["--steps", "3", "--ckpt-dir", str(d / writer),
                     "--resume"]
    run = _procs(resume) if reader == "procs" else _threads(resume)
    _resumed(run, whole, threads)


def _raises_naming_rank_0(argv, exc):
    t0 = time.monotonic()
    with pytest.raises(exc) as info:
        _procs(argv)
    assert time.monotonic() - t0 < DEADLINE  # no rank waited it out
    assert any("raised by rank 0" in n
               for n in getattr(info.value, "__notes__", [])), info.value
    return info.value


def test_an_unwritable_ckpt_dir_stops_the_world(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    _raises_naming_rank_0(GPT3 + ["--devices", "2", "--steps", "2",
                                  "--ckpt-dir", str(blocker / "ck"),
                                  "--ckpt-every", "2"], OSError)
    assert blocker.read_text() == ""


def test_a_failed_write_raises_and_leaves_no_latest(tmp_path):
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "step_2").write_text("")  # the commit's rename target is a file
    _raises_naming_rank_0(GPT3 + ["--devices", "2", "--steps", "2",
                                  "--ckpt-dir", str(ck), "--ckpt-every",
                                  "2"], OSError)
    assert not (ck / "LATEST").exists()


def test_a_missing_leaf_at_restore_stops_the_world(gpt3_2x2, tmp_path):
    argv, d, _, _ = gpt3_2x2
    ck = tmp_path / "ck"
    (ck / "step_2").mkdir(parents=True)
    (ck / "LATEST").write_text("2")
    src = d / "p" / "step_2"
    (ck / "step_2" / "manifest.json").write_text(
        (src / "manifest.json").read_text())
    with np.load(src / "shard_0.npz") as z:
        kept = {k: z[k] for k in z.files[1:]}
    np.savez(ck / "step_2" / "shard_0.npz", **kept)
    err = _raises_naming_rank_0(argv + ["--steps", "3", "--ckpt-dir",
                                        str(ck), "--resume"], KeyError)
    assert "checkpoint missing leaf" in str(err)


def test_ckpt_flags_without_a_dir_stop_under_procs():
    for extra in (["--resume"], ["--ckpt-every", "2"]):
        with pytest.raises(SystemExit, match="needs --ckpt-dir"):
            train.main(GPT3 + ["--devices", "2", "--procs"] + extra)


@pytest.fixture(scope="module")
def moves():
    """The three cases in one world: a disagreement raises on every rank
    after the same header exchange, so the ranks stay in step."""
    calls = [(case, "host_moves", (case,))
             for case in ("shape", "other", "ok")]
    return mesh_probes.merge(spawn_world(
        mesh_probes.several, (calls,), 4, shape={"data": 2, "model": 2},
        device="cpu", deadline=DEADLINE, threads=1))


def test_host_moves_gather_scatter_and_share(moves):
    got = {r: v["ok"] for r, v in moves.items()}
    want = [torch.arange(r + 1, dtype=torch.float32) for r in range(4)]
    mesh_probes.check_same_bits(got[0]["gathered"], want, "gathered")
    for r in range(4):
        if r:
            assert got[r]["gathered"] == [None] * 4
        mesh_probes.check_same_bits(
            got[r]["received"], torch.full((2, 3), r, dtype=torch.bfloat16),
            f"rank {r}")
        assert got[r]["shared"] == [7, None]


@pytest.mark.parametrize("case,match", [
    ("shape", "rank 0 sends .*rank 1 expects"),
    ("other", "called different collectives"),
])
def test_host_moves_that_disagree_raise_on_every_rank(moves, case, match):
    import re

    for r, out in moves.items():
        assert re.search(match, out[case]), (r, out[case])


def test_the_store_reads_each_member_checked_by_its_crc(tmp_path):
    """``ckpt/store.read_member``, the restore's reader: every member of
    an ``np.savez`` file back with its dtype, shape and values (a scalar,
    a Fortran-ordered and an empty array among them); a flipped byte fails
    the zip's CRC-32, and a compressed member is refused."""
    from repro_torch.ckpt.store import npz_members, read_member

    rng = np.random.default_rng(0)
    arrays = {"['opt_state']['m'][0]": rng.standard_normal((3, 4)).astype(
        np.float32), "ids": np.arange(10), "scalar": np.float32(3.5),
        "fortran": np.asfortranarray(rng.standard_normal((5, 6))),
        "empty": np.zeros((0, 3), np.float32),
        "mask": np.array([True, False])}
    path = tmp_path / "shard_0.npz"
    np.savez(path, **arrays)
    for info in npz_members(str(path)):
        got, want = read_member(str(path), info), arrays[info.filename[:-4]]
        assert got.dtype == want.dtype and got.shape == np.shape(want)
        assert np.array_equal(got, want), info.filename
    raw = bytearray(path.read_bytes())
    raw[raw.find(b"NUMPY") + 130] ^= 0xFF  # the first member's data
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32"):
        for info in npz_members(str(path)):
            read_member(str(path), info)
    np.savez_compressed(tmp_path / "z.npz", **arrays)
    with pytest.raises(ValueError, match="compressed"):
        read_member(str(tmp_path / "z.npz"),
                    npz_members(str(tmp_path / "z.npz"))[0])
