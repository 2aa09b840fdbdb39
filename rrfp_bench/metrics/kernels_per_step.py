"""Device kernels a traced step launched (copies and fills by the copy
engines, ``Memcpy``/``Memset``, not counted)."""


def read(ctx):
    n = sum(1 for name, _, _ in ctx["kernels"]
            if not name.startswith(("Memcpy", "Memset")))
    return n / ctx["steps"] if n else None
