"""Deterministic synthetic data pipeline with host-side prefetch (numpy).

A copy of the reference's ``repro.data.synthetic`` (language and
multimodal batches): the same (seed, step) gives the same arrays in both
packages.

Batches are reproducible functions of (seed, step) — restart-safe: resuming
from a checkpoint at step k regenerates exactly the stream the crashed run
would have seen.  Token streams follow a Zipfian unigram mix with induced
bigram structure so the LM loss has signal to descend.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.data.lengths import bucket_for, sample_token_lengths
from repro_torch.models.common import ArchConfig


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synth_batch(cfg: ArchConfig, batch: int, seq: int, *, seed: int = 0,
                step: int = 0, enc_len: int = 0) -> dict:
    """One global batch for ``cfg``: tokens/labels (+ stub embeddings)."""
    rng = _rng(seed, step)
    toks = _token_stream(rng, cfg.vocab_size, batch, seq)
    out = {
        "tokens": toks[:, :seq].astype(np.int32),
        "labels": toks[:, 1 : seq + 1].astype(np.int32),
    }
    if cfg.embed_input:
        out["embeds"] = (rng.standard_normal((batch, seq, cfg.d_model)) * 0.02
                         ).astype(np.float32)
    if cfg.mrope:
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (3, batch, seq))
        out["mrope"] = pos.copy()
    if cfg.encoder_layers:
        out["enc_embeds"] = (
            rng.standard_normal((batch, enc_len or seq, cfg.d_model)) * 0.02
        ).astype(np.float32)
    return out


def _token_stream(rng: np.random.Generator, v: int, batch: int,
                  seq: int) -> np.ndarray:
    """Zipf unigram + deterministic bigram successors (learnable signal)."""
    base = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64) % v
    succ = (np.arange(v) * 31 + 7) % v
    follow = rng.random((batch, seq + 1)) < 0.5
    toks = base.copy()
    toks[:, 1:] = np.where(follow[:, 1:], succ[toks[:, :-1]], base[:, 1:])
    return toks


def multimodal_batch(mm_cfg, num_microbatches: int, mb_rows: int, *,
                     seed: int = 0, step: int = 0,
                     bucketing: bool = True) -> dict:
    """One global batch for a branch+fusion multimodal pipeline.

    Per-microbatch encoder-token counts come from the shared modality
    length sampler (``repro_torch.data.lengths`` — the same distribution the DES
    cost models use for compute skew).  With ``bucketing`` each
    microbatch's encoder embeddings are zero-padded up to the smallest
    config bucket that fits (bounding jit retraces by the bucket count);
    without it they stay at their exact length (one retrace per distinct
    length — the reference the bitwise parity tests compare against).

    Returns ``tokens``/``labels`` ([M*mb_rows, text_seq]), ``enc_embeds``
    (list of M ``[mb_rows, padded_len, d_enc]`` float32 arrays) and
    ``enc_lens`` ([M] valid token counts).
    """
    rng = _rng(seed, step)
    batch = num_microbatches * mb_rows
    toks = _token_stream(rng, mm_cfg.vocab_size, batch, mm_cfg.text_seq)
    lens = sample_token_lengths(
        num_microbatches, mm_cfg.mean_enc_tokens, mm_cfg.enc_sigma,
        seed=seed, step=step, lo=mm_cfg.fusion_slots,
        hi=max(mm_cfg.buckets))
    enc_embeds = []
    for j in range(num_microbatches):
        n = int(lens[j])
        pad = bucket_for(n, mm_cfg.buckets) if bucketing else n
        x = np.zeros((mb_rows, pad, mm_cfg.d_enc), np.float32)
        x[:, :n] = (rng.standard_normal((mb_rows, n, mm_cfg.d_enc))
                    * 0.02).astype(np.float32)
        enc_embeds.append(x)
    return {
        "tokens": toks[:, :mm_cfg.text_seq].astype(np.int32),
        "labels": toks[:, 1:mm_cfg.text_seq + 1].astype(np.int32),
        "enc_embeds": enc_embeds,
        "enc_lens": lens.astype(np.int32),
    }


class PrefetchIterator:
    """Host-side prefetch: a producer thread keeps ``depth`` batches ready so
    input generation overlaps device compute (the data-pipeline half of
    compute/IO overlap at scale)."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
