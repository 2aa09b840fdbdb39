"""Dry run of every (architecture × shape) cell on the production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \
        --shape train_4k [--multi-pod] [--schedule rrfp] [--out out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's step over 512 placeholder devices and reads XLA's memory and cost
analyses and the collectives of its HLO.  The port has no compiler and no
placeholder devices.  For each cell it plans over
``make_production_mesh(device="meta")``, runs ``build_cell`` and then
``roofline.per_op_costs``, which builds every stage archetype's op bodies
on meta tensors: a shape error in any cell raises there, the port's
stand-in for "the cell lowers".  Nothing is allocated on any device.

Each result keeps the reference's keys where the port can fill them:

* ``memory``: ``argument_bytes``, the bytes of one rank's arguments taken
  exactly from the meta structures (its stage module, io module and
  ZeRO-1 state and its batch shard for a train cell; its stage module, io
  module, cache shard and batch shard for a decode cell), for the rank
  that holds the most; ``output_bytes`` likewise (its grad shards, expert
  grads and metrics; its tokens and last hidden state); ``temp_bytes``
  and ``generated_code_bytes`` null: PyTorch has no compiled buffer
  assignment.  ``model`` is ``analysis/memory_model.cell_memory``.
* ``cost_raw``: FLOPs and bytes of the busiest rank's step, from the
  roofline's counts of each op times the ops of the step.
* ``collectives``: the calls of ``build_cell``'s step function, by kind and
  summed over ranks, counted from the schedule table and the executor's
  issue pattern, as ``Mesh.counts`` reads them after a run.  The
  reference's regex counts the collective ops of the program text, with a
  loop body once; the port counts the calls a step makes.

A cell the port refuses by design is reported under ``refused`` with the
reason and the reference's line, not as an error: ``zamba2-1.2b`` ×
``long_500k`` (its shared block under ``sp_mode``, ROADMAP §3 gap (a)) and
every ``long_500k`` cell on the multi-pod mesh (``sp_mode`` with
``multi_pod``, gap (b)).  The exit code counts errors only.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from collections import Counter

import torch

from repro_torch.analysis.memory_model import cell_memory
from repro_torch.analysis.roofline import per_op_costs, step_costs
from repro_torch.launch import cells as cells_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.build import ATTN_KINDS
from repro_torch.models.moe import CUTS, sharded
from repro_torch.models.phases import TRANSPOSE
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.pipeline.decode import cache_specs
from repro_torch.pipeline.executor import ExecOptions
from repro_torch.pipeline.sharding import partition_for
from repro_torch.pipeline.spec import OP_B, OP_F, OP_W

#: the refusal's ``ValueError`` message starts so (``decode.check_sp_mode``)
_REFUSED = "sp_mode"
#: per_op_costs by the plan's op shapes, counted once a process
_COSTS: dict = {}


def _bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, torch.nn.Module):
        return sum(_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    return 0


def _shard_bytes(t: torch.Tensor, dim: int, n: int) -> int:
    return t.numel() // t.shape[dim] * (t.shape[dim] // n) * t.element_size()


def zero1_state_bytes(partition, stage_params, io, dp_total: int,
                      opt_cfg: AdamWConfig | None = None) -> int:
    """Bytes of one rank's ``make_optimizer`` state: master, m and v of its
    float32 shard of every data-replicated leaf (``ceil(n / dp_total)``
    elements), m and v of its expert leaves in ``expert_state_dtype``."""
    opt_cfg = opt_cfg or AdamWConfig()
    flags = partition.stage_data_sharded
    total = 0
    for k, slots in partition.stage_leaves(stage_params.parameters()).items():
        n = sum(p.numel() for p in slots)
        if flags[k]:
            total += 2 * n * opt_cfg.expert_state_dtype.itemsize
        else:
            total += 3 * math.ceil(n / dp_total) * 4
    for p in io.parameters():
        total += 3 * math.ceil(p.numel() / dp_total) * 4
    return total


def _train_output_bytes(partition, stage_params, io, dp_total: int,
                        opts: ExecOptions) -> int:
    """Bytes of a train rank's ``(metrics, grad_shards, expert_grads)``."""
    flags = partition.stage_data_sharded
    item = opts.flat_dtype.itemsize
    total = 2 * 4  # loss_sum, loss
    for k, slots in partition.stage_leaves(stage_params.parameters()).items():
        n = sum(p.numel() for p in slots)
        total += (n * opts.grad_dtype.itemsize if flags[k]
                  else math.ceil(n / dp_total) * item)
    for p in io.parameters():
        total += math.ceil(p.numel() / dp_total) * item
    return total


def rank_memory(plan, mesh, args, batch_specs) -> dict:
    """``argument_bytes`` and ``output_bytes`` of the rank that holds the
    most (every rank of a ``model`` index holds the same)."""
    model = plan.model
    cfg = model.cfg
    dp_axes = ("pod", "data") if plan.multi_pod else ("data",)
    dp_total = mesh.group_size(dp_axes)
    stage_mods, io = args[0], args[1]
    batch = args[3] if plan.step == "decode" else args[2]
    shard = 0
    for k, t in batch.items():
        spec = batch_specs[k]
        shard += _bytes(t) if spec is None else _shard_bytes(
            t, spec[0], mesh.group_size(spec[1]))
    partition = partition_for(model, stage_mods[0], io)
    if plan.step == "train":
        opts = cells_lib.exec_options(plan)
        per_stage = [(_bytes(sp) + _bytes(io) + shard
                      + zero1_state_bytes(partition, sp, io, dp_total),
                      _train_output_bytes(partition, sp, io, dp_total, opts))
                     for sp in stage_mods]
    else:
        caches = args[2]
        specs = cache_specs(model, cells_lib.decode_options(plan))

        def cache_bytes(tree, spec):
            if isinstance(tree, dict):
                return sum(cache_bytes(tree[k], spec[k]) for k in tree)
            # a rank's stage: [l_max, ...] of the global [S, l_max, ...]
            one = tree[0]
            return _bytes(one) if spec is None else _shard_bytes(
                one, spec[0], mesh.group_size(spec[1]))

        b_loc = (plan.cell.global_batch if plan.sp_mode
                 else plan.num_microbatches * plan.mb_rows)
        out = b_loc * 8 + b_loc * cfg.d_model * cfg.dtype.itemsize
        per_stage = [(_bytes(sp) + _bytes(io) + shard
                      + cache_bytes(caches, specs), out)
                     for sp in stage_mods]
    arg, out = max(per_stage)
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": None,
            "generated_code_bytes": None}


def step_collectives(plan, mesh, table=None) -> dict[str, int]:
    """Calls of ``build_cell``'s step function by collective, summed over
    the mesh's ranks (``Mesh.counts`` after one step).

    Train (``make_train_fn``): two ``ppermute`` a tick; a ``psum`` of the
    loss; a ``psum_scatter`` per data-replicated stage leaf and per io
    leaf, each io leaf after a ``psum`` over ``model``; a stage whose
    forward exchanges MoE tokens issues each MoE slot's two exchanges in
    F, and in a B or W those and their transposes.  Decode
    (``make_serve_fn``): a ``ppermute`` a tick; the tokens' ``psum``;
    under ``sp_mode`` a ``pmax`` and two ``psum`` per attention slot a
    group runs; an exchanging MoE slot's two exchanges per group."""
    model = plan.model
    S = model.num_stages
    data = mesh.shape["data"]
    ranks_a_stage = mesh.size // S
    aux = {"moe_layout": model.moe_layout, "data_size": data}
    counts: Counter = Counter()

    def kinds(s):
        return [model.layer_types[t] for t in model.type_ids[s] if t >= 0]

    def exchanges(s, transposed: bool) -> Counter:
        """One op's MoE exchanges at stage ``s``."""
        c: Counter = Counter()
        if not (sharded(model.moe_layout, data)
                and model.exchanges(model.rows(s), aux)):
            return c
        for _ in range(kinds(s).count("moe")):
            for cut in CUTS[model.moe_layout]:
                c[cut.name] += 1
                if transposed:
                    c[TRANSPOSE[cut.name]] += 1
        return c

    if plan.step == "train":
        table = table or cells_lib.schedule_table(plan)
        split = table.spec.split_backward
        counts["ppermute"] = 2 * table.num_ticks * mesh.size
        counts["psum"] = mesh.size
        sp = model.init_stage_params(0, seed=None, device="meta",
                                     data_size=data)
        io = model.init_io_params(seed=None, device="meta")
        part = partition_for(model, sp, io)
        n_rs = sum(not f for f in part.stage_data_sharded.values())
        counts["psum_scatter"] = (n_rs + len(part.io_keys)) * mesh.size
        counts["psum"] += len(part.io_keys) * mesh.size
        for s in range(S):
            ops = table.ops[s]
            n_f = int((ops == OP_F).sum())
            n_b = int((ops == OP_B).sum()) * (not split or s > 0)
            n_w = int((ops == OP_W).sum()) * split
            for name, n in exchanges(s, False).items():
                counts[name] += n_f * n * ranks_a_stage
            for name, n in exchanges(s, True).items():
                counts[name] += (n_b + n_w) * n * ranks_a_stage
    else:
        M = plan.num_microbatches
        counts["ppermute"] = (M + S - 1) * mesh.size
        counts["psum"] = mesh.size
        for s in range(S):
            if plan.sp_mode:
                n = sum(k in ATTN_KINDS for k in kinds(s))
                counts["pmax"] += M * n * ranks_a_stage
                counts["psum"] += 2 * M * n * ranks_a_stage
            for name, n in exchanges(s, False).items():
                counts[name] += M * n * ranks_a_stage
    return {k: v for k, v in sorted(counts.items()) if v}


def dryrun_cell(arch: str, shape: str, *, multi_pod: bool = False,
                schedule: str = "1f1b", num_stages: int = 16) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    plan = cells_lib.plan_cell(arch, shape, mesh, num_stages=num_stages)
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "schedule": schedule,
        "step": plan.step,
        "microbatches": plan.num_microbatches,
    }
    t0 = time.time()
    try:
        fn, args, batch_specs = cells_lib.build_cell(plan, mesh,
                                                     schedule=schedule)
    except ValueError as e:
        if not str(e).startswith(_REFUSED):
            raise
        # check_sp_mode refuses multi_pod first (gap (b)), then a layer
        # kind that ignores the sequence axis (gap (a))
        where = ("src/repro/launch/cells.py:101 plans it with sp_mode"
                 + (" and :196-198 with multi_pod" if plan.multi_pod else ""))
        gap = "b" if plan.multi_pod else "a"
        return {**result, "refused": f"{e} ({where}; ROADMAP §3, reference "
                                     f"gap ({gap}))"}
    t_build = time.time() - t0
    t0 = time.time()
    # the op bodies' shapes: a train cell's are the same on both meshes
    key = (arch, shape, plan.mb_rows, plan.seq_len, plan.enc_len,
           plan.sp_mode and plan.dp_total)
    if key not in _COSTS:
        _COSTS[key] = per_op_costs(plan)
    oc = _COSTS[key]
    t_count = time.time() - t0
    table = (cells_lib.schedule_table(plan, schedule)
             if plan.step == "train" else None)
    cost = step_costs(plan, oc)
    result.update({
        "build_s": round(t_build, 2),
        "count_s": round(t_count, 2),
        "memory": {**rank_memory(plan, mesh, args, batch_specs),
                   "model": cell_memory(plan).as_dict()},
        "cost_raw": {"flops": cost["flops"],
                     "bytes_accessed": cost["bytes"]},
        "collectives": step_collectives(plan, mesh, table),
    })
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--schedule", default="1f1b",
                    choices=["1f1b", "rrfp", "gpipe", "zb"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        targets = cells_lib.all_cells()
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        ok, why = cells_lib.cell_is_runnable(args.arch, args.shape)
        if not ok:
            print(f"SKIP {args.arch} × {args.shape}: {why}")
            return
        targets = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    results = []
    for arch, shape in targets:
        for mp in meshes:
            tag = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
            try:
                r = dryrun_cell(arch, shape, multi_pod=mp,
                                schedule=args.schedule)
                results.append(r)
                if "refused" in r:
                    print(f"REFUSED {tag}: {r['refused']}")
                    continue
                print(f"OK   {tag}: count={r['count_s']}s "
                      f"args={r['memory']['argument_bytes']:.4g} B "
                      f"model={r['memory']['model']['total']:.4g} B "
                      f"flops={r['cost_raw']['flops']:.4g} "
                      f"colls={r['collectives']}", flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "error": str(e)})
                print(f"FAIL {tag}: {e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    failed = [r for r in results if "error" in r]
    refused = [r for r in results if "refused" in r]
    print(f"\n{len(results) - len(failed) - len(refused)}/{len(results)} "
          f"cells passed, {len(refused)} refused by design")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
