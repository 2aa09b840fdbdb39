"""End-to-end training (port of ``examples/train_lm.py``): train an LM with
the RRFP-synthesized table, ZeRO-1 AdamW with warm-up, a prefetching data
iterator and a straggler monitor, on a 2 x 4 mesh of rank threads on one
device (the reference forced 8 host devices).  CPU-sized by default:
``--d-model 256`` gives 10,490,112 parameters, ``--full`` 163,597,056
(the reference's docstring says ~25M and ~100M for the same configs).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \
        [--device cpu]

The reference's ``--ckpt-dir`` is never read there, so it has no
counterpart here.  Like the reference, the run asserts that the last loss
is below the first.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import registry
from repro_torch.core.costs import CostModel
from repro_torch.core.taskgraph import PipelineSpec
from repro_torch.data.synthetic import PrefetchIterator, synth_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import _device_batch, rank_params, resolve_device
from repro_torch.models.build import build
from repro_torch.optim.adamw import AdamWConfig, make_optimizer
from repro_torch.pipeline import schedules
from repro_torch.pipeline.executor import ExecOptions, make_train_fn, shard_batch
from repro_torch.pipeline.sharding import partition_for
from repro_torch.runtime.straggler import StragglerMonitor

DATA, STAGES, MICROBATCHES = 2, 4, 8


def lm_config(d: int, layers: int, full: bool):
    """A custom llama-style config on the deepseek-7b family (the
    reference's): ``d`` wide, heads of 64, a 4d FFN."""
    base = registry.reduced_config("deepseek-7b", num_layers=layers)
    return dataclasses.replace(
        base, d_model=d, num_heads=max(4, d // 64),
        num_kv_heads=max(4, d // 64), head_dim=0, d_ff=4 * d,
        vocab_size=32768 if full else 4096, name=f"lm-{d}d{layers}L")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs CUDA")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="d 768, 12 layers, vocab 32768")
    return ap


def main(argv=None) -> list[float]:
    """Trains ``--steps`` steps; returns every step's loss."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    d = 768 if args.full else args.d_model
    layers = 12 if args.full else args.layers
    cfg = lm_config(d, layers, args.full)

    model = build(cfg, num_stages=STAGES)
    mesh = make_mesh(DATA, STAGES, device=device)
    # the launchers' seeded init: each stage and the io from their own
    # torch.Generator, copied to every data replica
    sp, io = rank_params(model, mesh, seed=0, device=device)
    part = partition_for(model, sp[0], io[0])
    spec = PipelineSpec(STAGES, MICROBATCHES)
    table = schedules.rrfp(spec)
    gt = DATA * MICROBATCHES * 1 * args.seq
    opts = ExecOptions(mb_rows=1, seq_len=args.seq, loss_scale=1.0 / gt)
    fn, batch_specs = make_train_fn(model, table, mesh, opts, part)
    oinit, oupd = make_optimizer(model, mesh, part,
                                 AdamWConfig(lr=6e-4, warmup_steps=40,
                                             total_steps=args.steps))
    opt = mesh.run(oinit, mesh.per_rank(lambda r: (sp[r], io[r])))

    def rank_step(sp, io, opt, batch, step):
        m, gs, eg = fn(sp, io, batch)
        return {**m, **oupd(sp, io, opt, gs, eg, step)}

    # as in the reference, the monitor is made for the loop's owner: the
    # table runtime reports no per-stage times to feed it
    StragglerMonitor(spec=spec, costs=CostModel.uniform(STAGES))
    print(f"params: {cfg.param_count():,}")
    it = PrefetchIterator(lambda s: synth_batch(
        cfg, DATA * MICROBATCHES, args.seq, step=s))
    losses = []
    t0 = time.time()
    try:
        for _ in range(args.steps):
            step, batch = next(it)
            shards = shard_batch(mesh, _device_batch(batch, device),
                                 batch_specs)
            m = mesh.run(rank_step, mesh.per_rank(
                lambda r: (sp[r], io[r], opt[r], shards[r], step)))[0]
            losses.append(float(m["loss"]))
            if step % 20 == 0 or step == args.steps - 1:
                print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                      f"gnorm {float(m['gnorm']):.3f}  "
                      f"{(time.time() - t0) / max(step, 1) * 1e3:6.1f} "
                      f"ms/step")
    finally:
        it.close()
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          f"steps")
    assert losses[-1] < losses[0]
    return losses


if __name__ == "__main__":
    main()
