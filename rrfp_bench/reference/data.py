"""The batches a training step sees: a frozen copy of ``_rng``,
``_token_stream`` and of the parts of ``synth_batch`` that a language
config uses (``src/repro_torch/data/synthetic.py:24-60``): the tokens and,
for a config whose inputs are embeddings supplied by a frontend stub, those
embeddings.

Batch ``step`` of a run seeded ``seed`` is a function of the two alone, so
the reference rebuilds what the program fed itself.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def token_stream(rng: np.random.Generator, v: int, batch: int,
                 seq: int) -> np.ndarray:
    """Zipf unigrams, and with probability 1/2 a token's fixed successor."""
    base = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64) % v
    succ = (np.arange(v) * 31 + 7) % v
    follow = rng.random((batch, seq + 1)) < 0.5
    toks = base.copy()
    toks[:, 1:] = np.where(follow[:, 1:], succ[toks[:, :-1]], base[:, 1:])
    return toks


def batch(vocab: int, rows: int, seq: int, *, seed: int, step: int,
          embed_d: int = 0) -> dict[str, np.ndarray]:
    """``tokens`` and next-token ``labels`` ``[rows, seq]`` (int64) of one
    step and, where ``embed_d`` is set, the frontend stub's float32
    ``embeds`` ``[rows, seq, embed_d]``, drawn after the tokens."""
    rng = _rng(seed, step)
    toks = token_stream(rng, vocab, rows, seq)
    out = {"tokens": toks[:, :seq], "labels": toks[:, 1:seq + 1]}
    if embed_d:
        out["embeds"] = (rng.standard_normal((rows, seq, embed_d)) * 0.02
                         ).astype(np.float32)
    return out

