"""Tokens trained a second: the tokens of every step that ended in the
window over the host-clock time those steps took."""


def read(ctx):
    if not ctx["window_steps"]:
        return None
    return ctx["tokens_per_step"] * len(ctx["window_steps"]) / ctx["window_s"]
