"""World programs that hold one mesh against another.

Each function here takes a mesh (the thread :class:`~repro_torch.launch.
mesh.Mesh` or a :class:`~repro_torch.launch.procs.ProcessMesh`) as its
first argument, builds the state of the mesh's local ranks from seeds,
runs a rank program on them with ``mesh.run`` and returns ``{rank:
result}`` for those ranks, on the host.  Called on the thread mesh it
returns every rank; given to ``procs.spawn_world`` it runs in each process
and the parent merges the ranks.  The two results must be equal bit for
bit: the tests (``tests/test_torch_procs_*.py``, gloo on the CPU) and
``chip_smoke.py`` (CUDA tensors) compare them.  They live in the package
so that a spawned process imports neither a test module nor JAX.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.configs import registry

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def merge(results) -> dict:
    """One ``{rank: result}`` of spawned processes' results (a list of
    dicts, one a process)."""
    out = {}
    for part in results:
        out.update(part)
    return dict(sorted(out.items()))


def axis_tuples(mesh) -> list[tuple[str, ...]]:
    """Every ordered tuple of distinct axes (the group index depends on
    the order: ``("model", "data")`` differs from ``("data", "model")``)."""
    return [p for k in range(1, len(mesh.axis_names) + 1)
            for p in itertools.permutations(mesh.axis_names, k)]


def collectives(mesh, seed: int, dtype: str) -> dict:
    """Every collective of the mesh over every axis tuple, on inputs drawn
    from ``numpy`` with ``(seed, rank)``: ``psum``, ``pmax``,
    ``psum_scatter``, ``all_gather`` (tiled and stacked), ``all_to_all``
    and ``axis_group``, and per axis ``ppermute`` of a tensor and of a
    ``(tensor, int, bool)`` tuple under a forward ring (zeros at its
    start), a backward ring and a rotation."""
    dt = DTYPES[dtype]

    def draw(rng, *shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt).to(mesh.device)

    def program(rank):
        rng = np.random.default_rng([seed, rank])
        out = {}
        for axes in axis_tuples(mesh):
            n = mesh.group_size(axes)
            key = "/".join(axes)
            x = draw(rng, 5, 3)
            rows = draw(rng, n, 4, 3)
            grp = mesh.axis_group(axes)
            out[key] = {
                "psum": mesh.psum(x, axes),
                "pmax": mesh.pmax(x, axes),
                "psum_scatter": mesh.psum_scatter(rows, axes),
                "all_gather": mesh.all_gather(x, axes),
                "all_gather_stacked": mesh.all_gather(x, axes, tiled=False),
                "all_to_all": mesh.all_to_all(rows, axes),
                "axis_group": (grp.index, grp.size, grp.psum(x[0]),
                               grp.pmax(x[1])),
                "psum_scalar": mesh.psum(x.sum().float(), axes),
            }
        for axis in mesh.axis_names:
            n = mesh.shape[axis]
            x = draw(rng, 2, 3)
            i = mesh.axis_index(axis)
            perms = {"forward": [(j, j + 1) for j in range(n - 1)],
                     "backward": [(j, j - 1) for j in range(1, n)],
                     "rotate": [(j, (j + 1) % n) for j in range(n)]}
            for name, perm in perms.items():
                out[f"ppermute/{axis}/{name}"] = mesh.ppermute(x, axis, perm)
                out[f"ppermute/{axis}/{name}/tuple"] = mesh.ppermute(
                    (x * 2, 10 * rank + i, i % 2 == 0), axis, perm)
        return _host(out)

    got = mesh.run(program, mesh.per_rank(lambda r: (r,)))
    return {r: got[r] for r in mesh.local_ranks}


def _collective_in_backward(mesh):
    class Summed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return mesh.psum(g, "model")

    x = torch.ones(3, requires_grad=True)
    return torch.autograd.grad(Summed.apply(x).sum(), x)


def faults(mesh, case: str, wait: float = 0.0) -> dict:
    """A rank program that fails on a 1 x 2 mesh: ``skip`` (rank 1 skips
    the ``pmax`` of rank 0 and returns after ``wait`` seconds), ``mismatch``
    (rank 0 ``psum_scatter``, rank 1 ``all_to_all`` of the same shape),
    ``backward`` (a ``psum`` inside a ``Function.backward``), ``raise``
    (rank 1 raises ``ValueError`` while rank 0 waits in a ``psum``), and
    ``hang`` (rank 0 sleeps ``wait`` seconds)."""
    def program(rank):
        x = torch.ones(2, 3, device=mesh.device)
        if case == "skip":
            if rank == 0:
                return mesh.pmax(x, "model")
            time.sleep(wait)
            return None
        if case == "mismatch":
            return (mesh.psum_scatter(x, "model") if rank == 0
                    else mesh.all_to_all(x, "model"))
        if case == "backward":
            return _collective_in_backward(mesh)
        if case == "raise":
            if rank == 1:
                raise ValueError("rank 1 fails before its psum")
            return mesh.psum(x, "model")
        if case == "hang":
            if rank == 0:
                time.sleep(wait)
            return None
        raise ValueError(f"no case {case!r}")

    got = mesh.run(program, mesh.per_rank(lambda r: (r,)))
    return {r: _host(got[r]) for r in mesh.local_ranks}


def host_moves(mesh, case: str) -> dict:
    """``ProcessMesh.move`` and ``share`` (a mesh of processes only):
    ``ok``: every rank moves a float32 tensor of its own length to rank 0,
    rank 0 moves each rank a bf16 tensor of the shape it expects, and every
    rank takes rank 0's integer and its None; ``shape`` (rank 1 expects
    another shape) and ``other`` (rank 1 calls ``share`` where the others
    call ``move``) return each rank's ``CollectiveError`` message."""
    from repro_torch.launch.mesh import CollectiveError

    me, n = mesh.rank, mesh.size
    mine = torch.arange(me + 1, dtype=torch.float32)
    like = torch.empty(2, 3, dtype=torch.bfloat16)
    try:
        if case == "other" and me == 1:
            mesh.share(None)
        if case in ("shape", "other"):
            mesh.move(like if me == 0 else None, src=0, dst=1,
                      like=torch.empty(3, 2, dtype=torch.bfloat16)
                      if case == "shape" else like)
            return {me: "no error"}
    except CollectiveError as e:
        return {me: str(e)}
    got = [mesh.move(mine if me == r else None, src=r, dst=0)
           for r in range(n)]
    sent = [mesh.move(torch.full((2, 3), r, dtype=torch.bfloat16)
                      if me == 0 else None, src=0, dst=r, like=like)
            for r in range(n)]
    return {me: {"gathered": got, "received": sent[me],
                 "shared": [mesh.share(7 if me == 0 else None),
                            mesh.share(None)]}}


def trainer(mesh, kw: dict, steps: int) -> dict:
    """``launch.train.build_trainer(mesh=mesh, **kw)`` for ``steps`` steps
    on the seeded batches: each local rank's losses, gnorms, parameters
    and ZeRO-1 state after the last step."""
    from repro_torch.data.synthetic import synth_batch
    from repro_torch.launch.train import _device_batch, build_trainer

    t = build_trainer(mesh=mesh, device=mesh.device, **kw)
    losses, gnorms = [], []
    for step in range(steps):
        batch = _device_batch(synth_batch(
            t["cfg"], t["batch_size"], t["seq"], seed=0, step=step,
            enc_len=t["opts"].enc_len), mesh.device)
        m = t["train_step"](batch, step)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    return {r: _host({
        "losses": losses, "gnorms": gnorms,
        "params": [p for mod in (t["stage_params"][r], t["io_params"][r])
                   for p in mod.parameters()],
        "opt_state": t["opt_state"][r],
    }) for r in mesh.local_ranks}


#: tag -> (arch, layers, experts, data, batch, cache_len, sp_mode, pos0,
#: steps): gemma3 under ``sp_mode`` (the caches sharded on their sequence
#: over the data ranks: ``pmax`` and the two ``psum`` of the distributed
#: flash-decode), the batch over the data ranks, and the MoE ``ep`` layout
#: at decode (its ``all_to_all`` exchanges); tests/test_torch_serve_mesh.py
#: holds the same cases against the reference
SERVE_CASES = {
    "sp_gemma": ("gemma3-4b", 6, None, 2, 1, 64, True, 28, 4),
    "dp_dense": ("deepseek-7b", 4, None, 2, 4, 16, False, 5, 3),
    "dp_moe_ep": ("deepseek-moe-16b", 4, 16, 2, 4, 16, False, 5, 3),
}


def serve(mesh, tag: str) -> dict:
    """``pipeline.decode.make_serve_fn`` of case ``tag`` (SERVE_CASES) on
    the mesh: seeded weights (``launch.train.rank_params``), caches drawn
    from ``numpy`` (rows past ``pos0`` zero) and sharded by
    ``convert.rank_caches_from_reference``, ``steps`` greedy steps: each
    local rank's tokens and last hidden states, and its caches after."""
    from repro_torch.launch.train import rank_params
    from repro_torch.models.build import build, tree_map
    from repro_torch.models.convert import rank_caches_from_reference
    from repro_torch.pipeline.decode import (
        DecodeOptions,
        cache_specs,
        make_serve_fn,
    )
    from repro_torch.pipeline.executor import shard_batch

    (arch, layers, experts, data, batch, cache_len, sp_mode, pos0,
     steps) = SERVE_CASES[tag]
    cfg = registry.reduced_config(arch, num_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    stages = mesh.shape["model"]
    model = build(cfg, num_stages=stages)
    enc_len = max(1, cache_len // 4)
    opts = DecodeOptions(mb_rows=1, cache_len=cache_len, enc_len=enc_len,
                         sp_mode=sp_mode)
    groups = 1 if sp_mode else batch // data
    sp, io = rank_params(model, mesh, seed=0, device=mesh.device)
    rng = np.random.default_rng(len(tag))
    one = model.init_layer_cache(batch, cache_len, enc_len, device="cpu")
    tree = tree_map(lambda c: rng.standard_normal(
        (stages, model.l_max) + tuple(c.shape)).astype(np.float32), one)
    for name in ("k", "v"):
        if name in tree:
            tree[name][:, :, :, pos0:] = 0
    caches = rank_caches_from_reference(model, mesh, tree,
                                        cache_specs(model, opts),
                                        mesh.device)
    fn, _, batch_specs = make_serve_fn(model, mesh, opts, groups)
    toks = torch.from_numpy(np.arange(batch) * 7 + 3).long().to(mesh.device)
    out: dict = {r: {"tokens": [], "hidden": []} for r in mesh.local_ranks}
    for pos in range(pos0, pos0 + steps):
        shards = shard_batch(mesh, {"tokens": toks}, batch_specs)
        got = mesh.run(fn, mesh.per_rank(
            lambda r: (sp[r], io[r], caches[r], shards[r], pos)))
        for r in mesh.local_ranks:
            out[r]["tokens"].append(_host(got[r][0]))
            out[r]["hidden"].append(_host(got[r][1]))
        # the batch's next tokens: under sp_mode every data rank holds
        # them all; else the data shards' (equal over model: a psum there)
        # gathered in data order
        first = mesh.local_ranks[0]
        toks = got[first][0] if sp_mode else mesh.run(
            lambda t: mesh.all_gather(t, "data"),
            mesh.per_rank(lambda r: (got[r][0],)))[first]
    for r in mesh.local_ranks:
        out[r]["caches"] = _host(caches[r])
    return out


def reference_serve_init(sp_tree: dict, io_tree: dict, cache_tree: dict,
                         model, mesh, device) -> tuple[list, list, list]:
    """``launch.serve.build_server``'s ``init`` from the reference's
    stacked weights and caches (numpy trees, as its serve test saves them):
    each local rank's stage module, io module and cache shard
    (``convert.rank_params_from_reference``, ``rank_caches_from_
    reference`` with the caches sharded over the data ranks on their
    batch)."""
    from repro_torch.models.convert import (
        rank_caches_from_reference,
        rank_params_from_reference,
    )
    from repro_torch.pipeline.decode import DecodeOptions, cache_specs

    sp, io = rank_params_from_reference(model, mesh, sp_tree, io_tree,
                                        device)
    specs = cache_specs(model, DecodeOptions(mb_rows=1, cache_len=1))
    return sp, io, rank_caches_from_reference(model, mesh, cache_tree, specs,
                                              device)


def serve_reference(mesh, arch: str, layers: int, batch: int,
                    cache_len: int, pos0: int, steps: int, first,
                    trees: tuple) -> dict:
    """``launch.serve.build_server`` of reduced ``arch`` on the mesh, its
    weights and caches loaded from the reference's ``trees`` (``sp``,
    ``io``, caches) through its ``init`` hook (:func:`reference_serve_init`),
    then ``steps`` greedy steps of its rank program from ``pos0``, each
    data rank fed its shard of ``first`` and then its own tokens: each
    local rank's tokens a step, the last stage's float32 logits a step
    (``head_logits`` of its hidden state; None elsewhere), and its caches
    after the run."""
    import functools

    from repro_torch.launch.serve import build_server

    s = build_server(arch, stages=mesh.shape["model"], layers=layers,
                     batch=batch, cache_len=cache_len,
                     data=mesh.shape["data"], mesh=mesh,
                     init=functools.partial(reference_serve_init, *trees))
    model, sp, io, caches = s["model"], s["sp"], s["io"], s["caches"]
    n = batch // mesh.shape["data"]
    first = torch.as_tensor(np.asarray(first)).long()
    toks = mesh.per_rank(lambda r: first[
        mesh.coords(r)["data"] * n:(mesh.coords(r)["data"] + 1) * n].to(
        mesh.device))
    out: dict = {r: {"tokens": [_host(toks[r])], "logits": []}
                 for r in mesh.local_ranks}
    for pos in range(pos0, pos0 + steps):
        got = mesh.run(s["rank_fn"], mesh.per_rank(lambda r: (
            sp[r], io[r], caches[r], {"tokens": toks[r]}, pos)))
        for r in mesh.local_ranks:
            toks[r], hidden = got[r]
            out[r]["tokens"].append(_host(toks[r]))
            with torch.inference_mode():
                out[r]["logits"].append(None if hidden is None else _host(
                    model.head_logits(io[r], hidden)[:, 0].float()))
    for r in mesh.local_ranks:
        out[r]["caches"] = _host(caches[r])
    return out


def reference_step(mesh, cfg, sched: str, mb: int, rows: int, seq: int,
                   sp_tree: dict, io_tree: dict, exec_kw: dict) -> dict:
    """One executor step (``pipeline.executor.make_train_fn``) of ``cfg``
    under ``sched`` from the reference's stacked weights (``sp_tree``,
    ``io_tree``: numpy, carried across by ``convert.rank_params_from_
    reference``) on the seeded batch of step 0: each local rank's loss,
    ZeRO-1 grad shards and expert grads."""
    from repro_torch.core.taskgraph import PipelineSpec
    from repro_torch.data.synthetic import synth_batch
    from repro_torch.launch.train import _device_batch
    from repro_torch.models.build import build
    from repro_torch.models.convert import rank_params_from_reference
    from repro_torch.pipeline import schedules
    from repro_torch.pipeline.executor import (
        ExecOptions,
        make_train_fn,
        shard_batch,
    )
    from repro_torch.pipeline.sharding import partition_for

    stages, data = mesh.shape["model"], mesh.shape["data"]
    model = build(cfg, num_stages=stages)
    sps, ios = rank_params_from_reference(model, mesh, sp_tree, io_tree,
                                          mesh.device)
    first = mesh.local_ranks[0]
    part = partition_for(model, sps[first], ios[first])
    table = schedules.BUILDERS[sched](
        PipelineSpec(stages, mb, split_backward=(sched == "zb")))
    batch_rows = data * mb * rows
    fn, specs = make_train_fn(model, table, mesh, ExecOptions(
        mb_rows=rows, seq_len=seq, loss_scale=1.0 / (batch_rows * seq),
        **exec_kw), part)
    batch = _device_batch(synth_batch(cfg, batch_rows, seq, seed=0, step=0),
                          mesh.device)
    shards = shard_batch(mesh, batch, specs)
    got = mesh.run(fn, mesh.per_rank(lambda r: (sps[r], ios[r], shards[r])))
    return {r: _host({"loss": float(got[r][0]["loss"]), "grads": got[r][1],
                      "expert_grads": got[r][2]}) for r in mesh.local_ranks}


def several(mesh, calls: list) -> dict:
    """Several world programs of this module in one world: ``calls`` a list
    of ``(label, function name, args)``; returns ``{rank: {label:
    result}}`` for the local ranks."""
    out: dict = {r: {} for r in mesh.local_ranks}
    for label, name, args in calls:
        for r, res in globals()[name](mesh, *args).items():
            out[r][label] = res
    return out


def check_same_bits(a, b, where: str = "") -> None:
    """Raise AssertionError unless ``a`` and ``b`` have the same structure,
    their tensors the same dtype, shape and bits, and their scalars the
    same type and value."""
    if type(a) is not type(b):
        raise AssertionError(f"{where}: {type(a).__name__} vs "
                             f"{type(b).__name__}")
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{where}: other bits ({a.dtype} "
                                 f"{tuple(a.shape)} vs {b.dtype} "
                                 f"{tuple(b.shape)})")
    elif isinstance(a, dict):
        if list(a) != list(b):
            raise AssertionError(f"{where}: keys {list(a)} vs {list(b)}")
        for k in a:
            check_same_bits(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: {len(a)} vs {len(b)} items")
        for i, (x, y) in enumerate(zip(a, b)):
            check_same_bits(x, y, f"{where}[{i}]")
    elif a != b:
        raise AssertionError(f"{where}: {a!r} vs {b!r}")
