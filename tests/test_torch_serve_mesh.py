"""The port's serve path on a ``(data x model)`` mesh against the reference.

One subprocess (JAX on 8 forced host devices) runs the reference's
``pipeline.decode.make_serve_fn`` under ``shard_map`` from seeded weights
and seeded caches, float32, reduced configs, and records each step's
tokens, its float32 logits (read at the reference's own ``argmax``) and
the caches after the run.  The port runs ``make_serve_fn`` on its
in-process mesh from the same weights and caches (carried across with
``models.convert``): tokens equal, logits within 1e-4, and every rank's
caches after the run equal to its shard of the reference's within 1e-4.
The cases:

* ``sp_gemma``: gemma3-4b (6 layers, window 8) under ``sp_mode`` on 2 x 2,
  cache 64 (32 rows a rank), 8 tokens from pos 28: the write and the
  local window cross the shard, and a local layer's shard on rank 0 ends
  fully masked;
* ``sp_xlstm``: xlstm-350m under ``sp_mode`` (its states replicated);
* ``dp_dense``: deepseek-7b, the batch of 4 over 2 data ranks;
* ``dp_moe_ep`` / ``dp_moe_tp``: deepseek-moe with 16 experts (``ep``)
  and its 8 (``tp``), the tokens exchanged over the data ranks;
* ``dp_seamless``: seamless-m4t-large-v2, seeded ``xk``/``xv`` (K3).

``serve --procs`` (one process per rank, gloo, one intra-op thread): a
2 x 2 world of four processes loads ``dp_dense``'s reference weights and
caches through ``build_server``'s ``init`` hook (tokens equal, logits and
every rank's caches within 1e-4); the CLI with ``--procs`` gives the
thread mesh's tokens bit for bit and the same collectives a step summed
over the ranks (deepseek-7b, deepseek-moe ``tp``, embed-input qwen2-vl,
enc-dec seamless); processes started by
hand join the world their variables set; the flags stop before a world
starts.

Two reference gaps (ROADMAP §3) are confirmed here on the reference's own
runs, against its unsharded run from the same state, and refused by the
port: (a) under ``sp_mode`` the ``dec``, ``moe``/``dense`` and zamba2
shared-block decodes ignore the sequence axis (each rank attends its own
shard), and (b) under ``multi_pod`` the caches are sharded over ``("pod",
"data")`` but combined over ``data``.
"""
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.build import build as jbuild
from repro.pipeline import decode as jdecode
from repro_torch.configs import registry
from repro_torch.launch import mesh_probes, serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.procs import spawn_world
from repro_torch.models.build import build, tree_map
from repro_torch.models.convert import (
    cache_from_reference,
    rank_caches_from_reference,
    rank_caches_to_reference,
    rank_params_from_reference,
)
from repro_torch.models.moe import take_shard
from repro_torch.pipeline.decode import (
    DecodeOptions,
    cache_specs,
    make_serve_fn,
    make_staircase_fn,
)
from repro_torch.pipeline.executor import shard_batch

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
#: tag -> (arch, layers, experts, pods, data, stages, batch, cache_len,
#: sp_mode, pos0, steps); the ``gap_`` cases also run unsharded on 1 x 2
CASES = {
    "sp_gemma": ("gemma3-4b", 6, None, 1, 2, 2, 1, 64, True, 28, 8),
    "sp_xlstm": ("xlstm-350m", 4, None, 1, 2, 2, 1, 16, True, 0, 4),
    "dp_dense": ("deepseek-7b", 4, None, 1, 2, 2, 4, 16, False, 5, 4),
    "dp_moe_ep": ("deepseek-moe-16b", 4, 16, 1, 2, 2, 4, 16, False, 5, 4),
    "dp_moe_tp": ("deepseek-moe-16b", 4, None, 1, 2, 2, 4, 16, False, 5, 4),
    "dp_seamless": ("seamless-m4t-large-v2", 4, None, 1, 2, 2, 4, 16, False,
                    5, 4),
    "gap_dec": ("seamless-m4t-large-v2", 4, None, 1, 2, 2, 1, 16, True, 6,
                4),
    "gap_moe": ("deepseek-moe-16b", 4, None, 1, 2, 2, 1, 16, True, 6, 4),
    "gap_shared": ("zamba2-1.2b", 4, None, 1, 2, 2, 1, 16, True, 6, 4),
    "gap_pod": ("gemma3-4b", 6, None, 2, 2, 2, 1, 64, True, 28, 4),
}
PARITY = [t for t in CASES if not t.startswith("gap_")]
GAPS = [t for t in CASES if t.startswith("gap_")]

REFERENCE = r"""
import dataclasses, json, os, sys
import numpy as np, jax, jax.numpy as jnp
import repro.pipeline.decode as jdec
from repro.configs import registry
from repro.launch.mesh import make_mesh
from repro.models.build import build
from repro.pipeline.decode import DecodeOptions, make_serve_fn
from repro.pipeline.sharding import partition_for

out, cases = sys.argv[1], json.loads(sys.argv[2])
ks = jax.tree_util.keystr
LOG = []
POD = {"on": False, "data": 1}


class _Jnp:
    # jax.numpy for the reference's decode module, but argmax records its
    # input, the step's float32 logits, with the data-parallel index
    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, logits, axis=None):
        i = jax.lax.axis_index("data")
        if POD["on"]:
            i = jax.lax.axis_index("pod") * POD["data"] + i
        jax.debug.callback(lambda i, v: LOG.append((int(i), np.asarray(v))),
                           i, logits)
        return jnp.argmax(logits, axis=axis)


jdec.jnp = _Jnp()


def leaves(prefix, tree):
    return {prefix + ks(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


def run(model, mesh, opts, groups, sp, io, cache, first, pos0, steps):
    wrap, _, _ = make_serve_fn(model, mesh, opts, groups)
    fn = jax.jit(wrap(partition_for(model, sp, io)))
    caches, toks = jax.tree.map(jnp.asarray, cache), jnp.asarray(first)
    tokens, logits = [np.asarray(first)], []
    for pos in range(pos0, pos0 + steps):
        LOG.clear()
        toks, caches = fn(sp, io, caches, {"tokens": toks},
                          jnp.asarray(pos, jnp.int32))
        toks.block_until_ready()
        jax.effects_barrier()
        by_rank = {}
        for i, v in LOG:
            by_rank.setdefault(i, []).append(v)
        logits.append(np.stack([np.concatenate(by_rank[i])
                                for i in sorted(by_rank)]))
        tokens.append(np.asarray(toks))
    return (np.stack(tokens), np.stack(logits),
            jax.tree.map(np.asarray, caches))


for tag, (arch, layers, experts, pods, data, stages, batch, cache_len, sp_mode,
          pos0, steps) in cases.items():
    cfg = registry.reduced_config(arch, num_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    model = build(cfg, num_stages=stages)
    key = jax.random.key(0)
    sp = model.init_stage_params(key)
    io = model.init_io_params(jax.random.fold_in(key, 1))
    enc_len = max(1, cache_len // 4)
    rng = np.random.default_rng(len(tag))
    cache = jax.tree.map(lambda c: rng.standard_normal(
        (stages, model.l_max) + c.shape).astype(np.float32),
        model.init_layer_cache(batch, cache_len, enc_len))
    for name in ("k", "v"):  # rows at and past pos0 not yet written
        if name in cache:
            cache[name][:, :, :, pos0:] = 0
    if "slstm" in cache:  # a reachable normaliser (tests/test_torch_serve.py)
        cache["slstm"]["n"] = 1.0 + np.abs(cache["slstm"]["n"])
    first = (np.arange(batch) * 7 + 3).astype(np.int32)
    POD.update(on=pods > 1, data=data)
    opts = DecodeOptions(mb_rows=1, cache_len=cache_len, enc_len=enc_len,
                         sp_mode=sp_mode, multi_pod=pods > 1)
    mesh = make_mesh(data, stages, pods)
    groups = 1 if sp_mode else batch // (data * pods)
    tokens, logits, final = run(model, mesh, opts, groups, sp, io, cache,
                                first, pos0, steps)
    arrays = {**leaves("sp", sp), **leaves("io", io),
              **leaves("cache", cache), **leaves("final", final),
              "tokens": tokens, "logits": logits}
    if tag.startswith("gap_"):
        POD.update(on=False, data=1)
        t1, l1, f1 = run(model, make_mesh(1, stages),
                         DecodeOptions(mb_rows=1, cache_len=cache_len,
                                       enc_len=enc_len),
                         batch, sp, io, cache, first, pos0, steps)
        arrays.update({"unsharded_tokens": t1, "unsharded_logits": l1,
                       **leaves("unsharded_final", f1)})
    np.savez(os.path.join(out, tag + ".npz"), **arrays)
    print(tag, "ok", flush=True)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("reference_serve_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(d), json.dumps(CASES)],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return d


def _tree(arrays, prefix: str) -> dict:
    """The nested tree of ``prefix + keystr`` entries."""
    out: dict = {}
    for k in arrays.files:
        if not k.startswith(prefix) or not k[len(prefix):].startswith("["):
            continue
        *parents, last = re.findall(r"\['([^']*)'\]", k[len(prefix):])
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arrays[k]
    return out


def _setup(tag: str, device="cpu"):
    """The case's model, mesh, options and groups (the reference's)."""
    (arch, layers, experts, pods, data, stages, batch, cache_len, sp_mode,
     _, _) = CASES[tag]
    cfg = registry.reduced_config(arch, num_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    model = build(cfg, num_stages=stages)
    mesh = make_mesh(data, stages, pods, device=device)
    opts = DecodeOptions(mb_rows=1, cache_len=cache_len,
                         enc_len=max(1, cache_len // 4), sp_mode=sp_mode,
                         multi_pod=pods > 1)
    groups = 1 if sp_mode else batch // (data * pods)
    return model, mesh, opts, groups


_PORT: dict = {}


def _port_run(reference: Path, tag: str) -> dict:
    """The port's mesh serve of case ``tag`` from the reference's weights
    and caches (cached per module): tokens [steps + 1, B], logits [steps,
    B, V], every rank's caches after the run."""
    if tag in _PORT:
        return _PORT[tag]
    arrays = np.load(reference / f"{tag}.npz")
    model, mesh, opts, groups = _setup(tag)
    pos0, steps = CASES[tag][-2:]
    sps, ios = rank_params_from_reference(model, mesh, _tree(arrays, "sp"),
                                          _tree(arrays, "io"), "cpu")
    specs = cache_specs(model, opts)
    caches = rank_caches_from_reference(model, mesh, _tree(arrays, "cache"),
                                        specs, "cpu")
    fn, _, batch_specs = make_serve_fn(model, mesh, opts, groups)
    toks = torch.from_numpy(arrays["tokens"][0]).long()
    tokens, logits = [toks], []
    data = mesh.shape["data"]
    for pos in range(pos0, pos0 + steps):
        shards = shard_batch(mesh, {"tokens": toks}, batch_specs)
        out = mesh.run(fn, [(sps[r], ios[r], caches[r], shards[r], pos)
                            for r in range(mesh.size)])
        last = [mesh.rank_of(data=i, model=model.num_stages - 1)
                for i in range(data)]
        # every data rank's logits (under sp_mode each computes them all)
        with torch.inference_mode():
            logits.append(torch.stack([
                model.head_logits(ios[r], out[r][1])[:, 0].float()
                for r in last]))
        toks = (out[0][0] if opts.sp_mode else
                torch.cat([out[mesh.rank_of(data=i)][0]
                           for i in range(data)]))
        tokens.append(toks)
    res = {"tokens": torch.stack(tokens).numpy(),
           "logits": torch.stack(logits).numpy(), "caches": caches,
           "mesh": mesh, "specs": specs, "model": model, "ranks": out}
    _PORT[tag] = res
    return res


@pytest.mark.parametrize("tag", PARITY)
def test_tokens_and_logits_match_reference(reference, tag):
    want = np.load(reference / f"{tag}.npz")
    got = _port_run(reference, tag)
    assert np.array_equal(got["tokens"], want["tokens"]), (
        got["tokens"], want["tokens"])
    # [steps, data ranks, rows, V]: under sp_mode every data rank's
    assert got["logits"].shape == want["logits"].shape
    np.testing.assert_allclose(got["logits"], want["logits"], atol=TOL,
                               rtol=TOL)
    if CASES[tag][8]:  # sp_mode: the data ranks agree
        for i in range(1, got["logits"].shape[1]):
            np.testing.assert_array_equal(got["logits"][:, i],
                                          got["logits"][:, 0])


def _check_caches(final: dict, caches: list, mesh, specs) -> None:
    """Every rank's caches against its shard of the reference's final
    caches, within TOL."""
    n = 0
    for r in range(mesh.size):
        s = mesh.coords(r)["model"]

        def check(t, a, spec, r=r, s=s):
            want = a[s]
            if spec is not None:
                dim, axes = spec
                want = take_shard(want, dim, mesh.group_size(axes),
                                  mesh.group_index(axes, r))
            np.testing.assert_allclose(t.numpy(), want, atol=TOL, rtol=TOL)

        tree_map(check, caches[r], final, specs)
        n += 1
    assert n == mesh.size


@pytest.mark.parametrize("tag", PARITY)
def test_caches_after_the_run_match_reference_shard_by_shard(reference, tag):
    final = _tree(np.load(reference / f"{tag}.npz"), "final")
    got = _port_run(reference, tag)
    _check_caches(final, got["caches"], got["mesh"], got["specs"])


def test_serve_over_processes_from_the_reference_matches_it(reference):
    """``dp_dense`` on a 2 x 2 world of four processes (gloo, one intra-op
    thread): ``launch.serve.build_server(mesh=...)`` loads the reference's
    weights and caches through its ``init`` hook in every process
    (``mesh_probes.serve_reference``); the tokens are the reference's, the
    logits and every rank's caches after the run within TOL."""
    tag = "dp_dense"
    arrays = np.load(reference / f"{tag}.npz")
    arch, layers, _, _, data, stages, batch, cache_len, _, pos0, steps = (
        CASES[tag])
    trees = tuple(_tree(arrays, k) for k in ("sp", "io", "cache"))
    got = mesh_probes.merge(spawn_world(
        mesh_probes.serve_reference,
        (arch, layers, batch, cache_len, pos0, steps, arrays["tokens"][0],
         trees), data * stages, shape={"data": data, "model": stages},
        device="cpu", deadline=120.0, threads=1))
    model, mesh, opts, _ = _setup(tag)
    lead = [mesh.rank_of(data=i) for i in range(data)]
    last = [mesh.rank_of(data=i, model=stages - 1) for i in range(data)]
    tokens = np.stack([np.concatenate([got[r]["tokens"][k].numpy()
                                       for r in lead])
                       for k in range(steps + 1)])
    assert np.array_equal(tokens, arrays["tokens"]), (tokens,
                                                      arrays["tokens"])
    for r in got:  # every model rank holds its data shard's tokens
        twin = lead[mesh.coords(r)["data"]]
        assert all(torch.equal(a, b) for a, b in zip(got[r]["tokens"],
                                                     got[twin]["tokens"]))
    logits = np.stack([np.stack([got[r]["logits"][k].numpy() for r in last])
                       for k in range(steps)])
    assert logits.shape == arrays["logits"].shape
    np.testing.assert_allclose(logits, arrays["logits"], atol=TOL, rtol=TOL)
    _check_caches(_tree(arrays, "final"), [got[r]["caches"]
                                           for r in range(mesh.size)],
                  mesh, cache_specs(model, opts))


@pytest.mark.parametrize("tag", GAPS)
def test_reference_gap_is_confirmed_and_refused(reference, tag):
    """The reference's sharded run departs from its unsharded run from the
    same state: some data rank's logits and greedy tokens (the argmax the
    reference takes of them) and the caches; its data ranks disagree.  The
    port refuses the combination, naming the reference's line."""
    arrays = np.load(reference / f"{tag}.npz")
    sharded, unsharded = arrays["logits"], arrays["unsharded_logits"]
    n = sharded.shape[1]  # every data rank's [steps, ranks, rows, V]
    assert n > 1
    assert np.array_equal(unsharded[:, 0].argmax(-1).T,
                          arrays["unsharded_tokens"][1:].T)
    off = [float(np.abs(sharded[:, i] - unsharded[:, 0]).max())
           for i in range(n)]
    assert max(off) > 100 * TOL, off
    assert max(float(np.abs(sharded[:, i] - sharded[:, 0]).max())
               for i in range(n)) > 100 * TOL
    want = unsharded[:, 0].argmax(-1)
    assert any(not np.array_equal(sharded[:, i].argmax(-1), want)
               for i in range(n))
    k = _tree(arrays, "final")["k"]
    k1 = _tree(arrays, "unsharded_final")["k"]
    assert float(np.abs(k - k1).max()) > 100 * TOL
    model, mesh, opts, groups = _setup(tag)
    line = r"decode\.py:50" if tag == "gap_pod" else r"build\.py:\d+"
    with pytest.raises(ValueError, match=line):
        make_serve_fn(model, mesh, opts, groups)


#: (arch, layers, stages, batch): the mesh on 1 x S against the staircase
BITWISE = [("deepseek-7b", 5, 2, 3), ("gemma3-4b", 4, 2, 2),
           ("seamless-m4t-large-v2", 6, 3, 2), ("zamba2-1.2b", 3, 2, 2),
           ("deepseek-moe-16b", 3, 2, 2), ("xlstm-350m", 4, 2, 2)]


@pytest.mark.parametrize("arch,layers,stages,batch", BITWISE)
def test_mesh_on_one_data_rank_is_bitwise_the_staircase(arch, layers, stages,
                                                        batch):
    cfg = registry.reduced_config(arch, layers)
    model = build(cfg, stages)
    opts = DecodeOptions(mb_rows=1, cache_len=12, enc_len=3)
    sp = [model.init_stage_params(s, seed=2, device="cpu")
          for s in range(stages)]
    io = model.init_io_params(seed=2, device="cpu")
    gen = torch.Generator().manual_seed(5)
    caches = [tree_map(lambda t: torch.randn(t.shape, generator=gen),
                       model.init_stage_cache(batch, 12, 3, device="cpu"))
              for _ in range(stages)]
    if "slstm" in caches[0]:
        for c in caches:
            c["slstm"]["n"] = 1.0 + c["slstm"]["n"].abs()
    mesh = make_mesh(1, stages, device="cpu")
    rank_caches = copy.deepcopy(caches)
    rank_io = [copy.deepcopy(io) for _ in range(stages)]
    step = make_staircase_fn(model, opts, batch)
    fn, _, batch_specs = make_serve_fn(model, mesh, opts, batch)
    a = b = torch.arange(batch) * 5 + 1
    for pos in range(4):
        a = step(sp, io, caches, {"tokens": a}, pos)
        shards = shard_batch(mesh, {"tokens": b}, batch_specs)
        out = mesh.run(fn, [(sp[r], rank_io[r], rank_caches[r], shards[r],
                             pos) for r in range(stages)])
        b = out[0][0]
        assert all(torch.equal(o[0], b) for o in out)
        assert torch.equal(a, b)
    for s in range(stages):
        tree_map(lambda x, y: torch.testing.assert_close(
            x, y, rtol=0, atol=0, equal_nan=True), caches[s], rank_caches[s])


def test_serve_cli_on_a_mesh_gives_the_one_rank_tokens():
    common = ["--device", "cpu", "--arch", "deepseek-moe-16b", "--layers",
              "3", "--stages", "2", "--batch", "4", "--tokens", "3",
              "--cache-len", "16"]
    mesh_run = serve.main(common + ["--devices", "4"])
    one = serve.main(common)
    assert mesh_run.tokens == one.tokens
    assert one.collectives == [] and len(mesh_run.collectives) == 3
    # tp (8 experts) over 2 data ranks: per step and stage rank, one
    # all_gather and one psum_scatter per MoE layer and one-row group (2
    # groups a data rank); ppermute once per tick (M + S - 1 = 3), psum once
    moe_layers = 2
    for c in mesh_run.collectives:
        assert c["all_gather"][0] == c["psum_scatter"][0] == 2 * 2 * moe_layers
        assert c["ppermute"][0] == 4 * 3 and c["psum"][0] == 4
    with pytest.raises(SystemExit, match="multiple of --stages"):
        serve.main(common + ["--devices", "3"])


@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-moe-16b",
                                  "qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_serve_cli_with_procs_gives_the_thread_runs_bits(arch):
    """``serve.main([... "--procs"])`` on 2 x 2 (four processes, gloo) and
    the same command on the thread mesh, one intra-op thread on both
    sides: the same tokens bit for bit and the same collectives a step
    summed over the ranks (deepseek-moe-16b reduced: 8 experts, the ``tp``
    layout; qwen2-vl-2b: embeddings in, each process taking its rows of
    the seeded global draw; seamless: the enc-dec decode); every process
    reports back."""
    argv = ["--device", "cpu", "--arch", arch, "--layers", "3", "--stages",
            "2", "--devices", "4", "--batch", "4", "--tokens", "3",
            "--cache-len", "16"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        procs = serve.main(argv + ["--procs"])
        threads = serve.main(argv)
    finally:
        torch.set_num_threads(n)
    assert procs.tokens == threads.tokens
    assert len(procs.tokens) == 4 and len(procs.tokens[0]) == 4

    def calls(run):
        return [{k: c for k, (c, _) in step.items()}
                for step in run.collectives]

    assert calls(procs) == calls(threads) and len(calls(procs)) == 3
    assert "ppermute" in calls(procs)[0] and "psum" in calls(procs)[0]
    if arch == "deepseek-moe-16b":
        assert calls(procs)[0]["all_gather"] > 0  # tp over the data ranks
    assert [r["rank"] for r in procs.ranks] == [0, 1, 2, 3]
    assert [r["coords"] for r in procs.ranks] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    assert all(r["peak_bytes"] == 0 for r in procs.ranks)  # the CPU
    assert threads.ranks == [] and procs.warm_seconds > 0


def test_serve_processes_started_by_hand_join_the_world_their_variables_set(
        tmp_path):
    """What ``torchrun`` does: two processes of ``python -m
    repro_torch.launch.serve ... --procs`` with ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` set (a ``file://`` store for the address) serve
    their ranks of a 1 x 2 mesh; rank 0 prints the batch's rows, the
    thread run's."""
    from repro_torch.launch.procs import INIT_METHOD_ENV

    argv = ["--device", "cpu", "--arch", "deepseek-7b", "--layers", "2",
            "--stages", "2", "--devices", "2", "--batch", "2", "--tokens",
            "2", "--cache-len", "8"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT / "src"), **{
                       INIT_METHOD_ENV: "file://" + str(tmp_path / "store")})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv,
             "--procs"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    rows = [re.findall(r"^ +(\[[\d, ]+\])$", o, re.M) for o in outs]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        threads = serve.main(argv)
    finally:
        torch.set_num_threads(n)
    assert rows[0] == [str(r) for r in threads.tokens] and rows[1] == []


@pytest.mark.parametrize("argv,match", [
    (["--dist-backend", "gloo"], "--dist-backend picks the backend of "
                                 "--procs"),
    (["--procs", "--dist-backend", "nccl"], r"4 ranks on \d card"),
    (["--procs", "--dist-backend", "nccl", "--device", "cpu"],
     "--device cpu takes gloo"),
])
def test_serve_procs_flags_stop_before_a_world_starts(argv, match):
    common = ["--arch", "deepseek-7b", "--layers", "2", "--stages", "2",
              "--devices", "4", "--tokens", "1"]
    with pytest.raises(SystemExit, match=match):
        serve.main(common + argv)


def test_serve_procs_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "deepseek-7b", "--layers", "2", "--stages",
                    "2", "--tokens", "1", "--procs"])


def test_cache_specs_match_the_reference():
    for arch, sp_mode, multi_pod in [("seamless-m4t-large-v2", False, False),
                                     ("seamless-m4t-large-v2", True, False),
                                     ("xlstm-350m", True, True),
                                     ("zamba2-1.2b", False, True)]:
        jm = jbuild(jreg.reduced_config(arch, 4), 2)
        tm = build(registry.reduced_config(arch, 4), 2)
        kw = dict(mb_rows=1, cache_len=8, enc_len=2, sp_mode=sp_mode,
                  multi_pod=multi_pod)
        want = jdecode.cache_specs(jm, jdecode.DecodeOptions(**kw))
        got = cache_specs(tm, DecodeOptions(**kw))

        def check(spec, pspec):
            assert pspec[0] == "model"
            sharded = [(i - 1, (a,) if isinstance(a, str) else tuple(a))
                       for i, a in enumerate(pspec) if i and a is not None]
            assert sharded == ([] if spec is None else [spec]), (spec, pspec)

        tree_map(check, got, dict(want))


@pytest.mark.parametrize("arch,sp_mode,pods", [
    ("deepseek-7b", False, 1), ("gemma3-4b", True, 1),
    ("seamless-m4t-large-v2", False, 1), ("seamless-m4t-large-v2", True, 1),
    ("xlstm-350m", True, 2)])
def test_rank_caches_round_trip_through_the_reference_layout(arch, sp_mode,
                                                             pods):
    """Each rank's shard is its block of the reference's ``[S, l_max, b,
    ...]`` tree under the reference's ``cache_specs`` (``P("model", ...)``
    over the mesh, the pod axis slowest), and back gives the tree."""
    stages, data, batch, seq = 2, 2, 4, 8
    kw = dict(mb_rows=1, cache_len=seq, enc_len=4, sp_mode=sp_mode,
              multi_pod=pods > 1)
    jm = jbuild(jreg.reduced_config(arch, 4), stages)
    tm = build(registry.reduced_config(arch, 4), stages)
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda c: rng.standard_normal(
        (stages, jm.l_max) + c.shape).astype(np.float32),
        jm.init_layer_cache(batch, seq, 4))
    pspecs = jdecode.cache_specs(jm, jdecode.DecodeOptions(**kw))
    mesh = make_mesh(data, stages, pods, device="cpu")
    specs = cache_specs(tm, DecodeOptions(**kw))
    ranks = rank_caches_from_reference(tm, mesh, tree, specs, "cpu")
    for r in range(mesh.size):
        c = mesh.coords(r)

        def block(a, pspec):
            idx = [slice(None)] * a.ndim
            for dim, axes in enumerate(pspec):
                if axes is None:
                    continue
                axes = (axes,) if isinstance(axes, str) else axes
                n, i = 1, 0
                for ax in axes:
                    n, i = n * mesh.shape[ax], i * mesh.shape[ax] + c[ax]
                size = a.shape[dim] // n
                idx[dim] = slice(i * size, (i + 1) * size)
            return a[tuple(idx)][0]  # the rank's stage

        tree_map(lambda t, a, p: np.testing.assert_array_equal(
            t.numpy(), block(a, p)), ranks[r], tree,
            jax.tree.map(lambda p: p, dict(pspecs),
                         is_leaf=lambda x: not isinstance(x, dict)))
    back = rank_caches_to_reference(tm, mesh, ranks, specs)
    tree_map(np.testing.assert_array_equal, back, tree)
    if sp_mode and "xk" in tree:  # enc_len rows sharded too
        assert ranks[0]["xk"].shape[2] == 4 // (data * pods)


def test_mesh_serve_refuses_a_model_axis_of_other_size():
    model = build(registry.reduced_config("deepseek-7b", 4), 2)
    with pytest.raises(ValueError, match="2 stages on a model axis of 4"):
        make_serve_fn(model, make_mesh(1, 4, device="cpu"),
                      DecodeOptions(mb_rows=1, cache_len=8), 1)
    with pytest.raises(ValueError, match="make_serve_fn on a mesh"):
        make_staircase_fn(model, DecodeOptions(mb_rows=1, cache_len=8,
                                               sp_mode=True), 1)


def test_a_rank_whose_shard_is_fully_masked_adds_nothing():
    """A local layer once ``pos`` has left rank 0's shard: rank 0's scores
    are all masked, the combine gives the unsharded decode's result, and
    only the rank holding row ``pos`` writes it (the others' caches stay
    bit for bit)."""
    from repro_torch.models import layers

    cfg = registry.reduced_config("gemma3-4b", 2)
    attn = layers.Attention(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    seq, shard, pos, window = 16, 8, 12, 3
    kv = (1, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    whole = {k: torch.from_numpy(rng.standard_normal(kv).astype(np.float32))
             for k in ("k", "v")}
    x = torch.from_numpy(rng.standard_normal((1, 1, cfg.d_model))
                         .astype(np.float32))
    parts = [{k: v[:, i * shard:(i + 1) * shard].clone()
              for k, v in whole.items()} for i in range(2)]
    before = copy.deepcopy(parts)
    with torch.inference_mode():
        want, _ = layers.decode_attention_block(attn, x, whole, pos, cfg,
                                                window=window)
    mesh = make_mesh(2, 1, device="cpu")

    def rank(r):
        with torch.inference_mode():
            return layers.decode_attention_block(
                attn, x, parts[r], pos, cfg, window=window,
                axis=mesh.axis_group("data"))[0]

    got = mesh.run(rank, [(0,), (1,)])
    assert torch.equal(got[0], got[1])
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-6)
    for k in ("k", "v"):
        assert torch.equal(parts[0][k], before[0][k])  # not its row
        local = pos - shard
        assert torch.equal(parts[1][k][:, local], whole[k][:, pos])
        rest = [j for j in range(shard) if j != local]
        assert torch.equal(parts[1][k][:, rest], before[1][k][:, rest])
    assert mesh.counts == {"pmax": 2, "psum": 4}


@pytest.mark.parametrize("as_tensors", [False, True])
def test_cache_from_reference_of_one_rank_is_the_rank_conversion(
        as_tensors):
    """On a ``1 x S`` mesh each rank's cache is the stage's whole cache
    (``cache_from_reference``), from numpy arrays or tensors (the card
    fills a full-size cache on the device)."""
    model = build(registry.reduced_config("seamless-m4t-large-v2", 4), 2)
    rng = np.random.default_rng(6)
    tree = tree_map(lambda t: rng.standard_normal(
        (2,) + tuple(t.shape)).astype(np.float32),
        model.init_stage_cache(2, 8, 3, device="cpu"))
    if as_tensors:
        tree = tree_map(torch.from_numpy, tree)
    mesh = make_mesh(1, 2, device="cpu")
    specs = cache_specs(model, DecodeOptions(mb_rows=1, cache_len=8))
    ranks = rank_caches_from_reference(model, mesh, tree, specs, "cpu")
    for s, (a, b) in enumerate(zip(ranks, cache_from_reference(
            model, tree, "cpu"))):
        tree_map(lambda x, y, w: (
            torch.testing.assert_close(x, y, rtol=0, atol=0),
            np.testing.assert_array_equal(x.numpy(), np.asarray(w[s]))),
            a, b, tree)
