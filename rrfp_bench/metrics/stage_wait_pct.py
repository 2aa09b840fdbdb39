"""Share of a traced step's pipeline run (%) in which the stage threads
had no ready task: 100 x the sum over stages of the runtime's ``blocking``
/ (stages x makespan), averaged over the traced steps' records
(``repro_torch.obs.spans``); none where the program keeps none."""


def read(ctx):
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    records = spans.recent(ctx["steps"])
    if not records:
        return None
    return 100.0 * sum(
        sum(r["blocking"]) / (len(r["blocking"]) * r["makespan"])
        for r in records) / len(records)
