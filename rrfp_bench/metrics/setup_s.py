"""Seconds from the start of the benchmark's process to the start of the
window: imports, the kernels' builds and compiles where a checkout has
none yet, the weights drawn on the card, and the two set-up steps (the
warm-up, and the steps the reference follows)."""


def read(ctx):
    return ctx["setup_s"]
