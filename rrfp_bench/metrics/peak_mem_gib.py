"""The device memory the window's steps held at their peak (GiB):
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start."""


def read(ctx):
    if not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2 ** 30
