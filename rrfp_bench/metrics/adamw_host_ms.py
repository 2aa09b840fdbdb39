"""Host milliseconds a traced step spent in the optimizer's update
(``rrfp.adamw``: AdamW's enqueue over every parameter), from the program's
step records (``repro_torch.obs.spans``); none where the program keeps
none."""


def read(ctx):
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    records = spans.recent(ctx["steps"])
    if not records:
        return None
    return 1e3 * sum(spans.seconds(r, "rrfp.adamw")
                     for r in records) / len(records)
