"""Host milliseconds a traced step spent on the trainer's main thread
outside ``rrfp.pipeline``, ``rrfp.adamw`` and ``rrfp.loss_sync``: the
serial host work (the batch, the programs, the gradient sums, the monitor
and the step line) that the device cannot overlap.  Read from the
program's step records (``repro_torch.obs.spans``); none where the program
keeps none."""
OVERLAPPED = ("rrfp.pipeline", "rrfp.adamw", "rrfp.loss_sync")


def read(ctx):
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    records = spans.recent(ctx["steps"])
    if not records:
        return None
    return 1e3 * sum(spans.seconds(r, "rrfp.step")
                     - sum(spans.seconds(r, n) for n in OVERLAPPED)
                     for r in records) / len(records)
