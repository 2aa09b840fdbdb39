"""Mean host milliseconds from a task's dispatch to its completion on its
stage thread (the runtime's own stamps in the traced steps' records,
``repro_torch.obs.spans``): kernel enqueue and the wait for the
interpreter lock, not device time.  None where the program keeps no
record."""


def read(ctx):
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    tasks = [t for r in spans.recent(ctx["steps"]) for t in r["tasks"]]
    if not tasks:
        return None
    return sum(t["end_ns"] - t["start_ns"] for t in tasks) / len(tasks) / 1e6
