#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py                # every phase, as the port's proof
    python3 chip_smoke.py --kernels-only # build + check the kernels, stop

Phases, each of which raises on failure (non-zero exit, no result line):

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. build the CUDA sources in ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   each, in parallel) and print their build logs (ptxas registers/spills);
3. every kernel against its plain PyTorch version on the card, at each main
   path's shapes and at the reference kernel tests' shapes, with the stated
   tolerance; then the kernel's time at each main path's shape beside its
   plain version's, one library call's (a yardstick only: the port never
   calls it) and the card's bound for the same work;
   K1 also in float32 at the examples' shapes (the reduced configs'
   head_dim 16, which only its float32 kernel takes), and with
   ``causal=False`` (the enc-dec encoder and
   cross-attention) at sq == sk and sq != sk with ragged edges, in both
   dtypes, and the plain attention backward there against autograd of
   the plain forward;
   K1b (K1's bf16 backward) against the plain backward at every K1
   shape in bf16, fed the forward kernel's out and lse, and timed at each
   main path's shape beside the plain backward and SDPA's backward;
   every K1, K1b, K3 and K4 check launches twice and requires the same bits,
   and each of their wrappers must refuse a view off 16-byte alignment
   (K4's bf16 kernel; its float32 kernel is the scalar one); K3 (flash
   decode) is also replayed from one CUDA graph at three lengths, written
   into its length tensor in place, twice each with the same bits (its
   arrival counters are back at 0 after every launch);
4. an end-to-end check on a small input per main path: the port's model
   forward on the card (kernels) against the same weights on the CPU
   (plain versions), at the arch's full widths (gemma3-4b too, for K1 at
   head_dim 256; deepseek-moe-16b's dense and MoE layers, xlstm-350m's
   7 mLSTM + 1 sLSTM layers at 320 tokens, qwen2-vl-2b with three
   distinct M-RoPE streams); one multimodal DAG step (forward and
   backward, every gradient compared); and the same for serving: seamless
   with 2 + 2 layers, 4 greedy tokens, then one more pass whose last
   hidden state is compared; and one step of the schedule-table executor
   (``--runtime table``: gpt3 at full width cut to 4 layers, seq 128, a
   1 x 4 mesh of ranks; seamless cut to 2 encoder + 2 decoder layers, 128
   tokens and 192 encoder frames, 1 x 2; deepseek-moe cut to its dense
   and first MoE layer, ``ep`` on 2 x 2), the loss, every ZeRO-1 grad
   shard and every routed expert's grad compared; and the MoE ``tp``
   layout at the level of the layer (reduced deepseek-moe, 8 experts)
   over a 2-rank mesh, forward and phased backward, against the CPU mesh
   and against ``layout="none"`` with the whole weights; and serving on a
   mesh of ranks (``phase_small_serve_mesh``): gemma3-4b cut to 6 layers
   under ``sp_mode`` on 2 x 2 (the write and the windows crossing the
   shard), deepseek-moe's dense and first MoE layer ``ep`` on 2 x 2 and the
   reduced 8-expert deepseek-moe ``tp``, tokens, logits and last hidden
   states against the CPU mesh;
5. the main paths, each through ``repro_torch.launch.train_actor`` (actor
   training, full width, 4 stages, 8 microbatches of 1 x 2048 tokens,
   bf16): ``paper-gpt3-large`` hint bf for 2 steps, then ``--hint bfw
   --split-backward`` for 1; ``zamba2-1.2b`` cut to 20 layers bf for 1
   step, then bfw for 1; ``deepseek-moe-16b`` cut to 4 layers
   (``cfg=registry.cut_depth``: the dense layer and 3 MoE layers) bf for
   1, bfw for 1; the language ``qwen2-vl-2b`` (M-RoPE) cut to 16 layers
   bf for 1, bfw for 1; ``xlstm-350m`` cut to 8
   layers bf for 1 step of 2 microbatches; the multimodal DAG (``--workload
   multimodal``, qwen2-vl-2b full width) bf for 2 steps, bfw for 1, and 2
   bf steps with the reference's full-size encoder settings (encoder
   microbatches of ~2048 tokens); right after the language paths, the
   schedule-table executor with ZeRO-1 (``--runtime table``,
   ``phase_table_path``): gpt3 on a 1 x 4 mesh of 8 microbatches under
   1f1b (2 steps), gpipe, zb and rrfp (1 step each), and on a 2 x 4 mesh
   of 4 microbatches per data rank under 1f1b (1 step), each run's K1 and
   K2 launches
   exactly as ``table_launches`` counts them, its step-0 loss within 1e-4
   of the actor bf run's, the 2 x 4 run's data replicas bitwise equal;
   then (``phase_moe_table_path``) ``deepseek-moe-16b`` cut to 4 layers
   through ``--runtime table`` on a 2 x 2 mesh (the ``ep`` layout, 32
   experts a data rank, 4 microbatches per data rank) under 1f1b and zb,
   its launches as ``table_launches`` counts them, its
   step-0 losses within 1e-4 of an actor bf step's on its 2 stages, its data
   replicas' replicated leaves bitwise equal and its collectives per step
   printed; then (``phase_procs_path``, ROADMAP 18a (ii)) the mesh of
   processes (``launch/procs.py``, one process per rank, gloo with its
   payloads staged through host memory): every collective on CUDA
   tensors in a 2 x 2 world of four processes bitwise the thread mesh's;
   gpt3 1f1b with ``--procs`` on 1 x 4 for 3 steps saving a table
   checkpoint at step 2 (18.9 GB, gathered through rank 0's host), the
   thread 1 x 4 run again for 3 steps (in turns; the same bits as the
   first and as the process run) whose step-2
   checkpoint tree every leaf of the file must equal (sha256), ``--procs
   --resume`` from it (step 2 bitwise the thread run's; bytes, gather,
   write and restore seconds and each process's host RSS printed), gpt3
   1f1b ``--procs`` on 2 x 4 (eight processes, 1 step) and deepseek-moe
   ``ep`` 1f1b ``--procs`` on 2 x 2 (cut to 2 layers, 1 step, and a thread
   run of that cut beside it), each with its thread run's losses, gnorms
   and every rank's replicated parameters (digests), K1/K2 launches
   summed over the processes as ``table_launches`` counts them, each
   process's peak memory and the card's ``memory.used`` printed;
   ``--dist-backend nccl`` with 4 ranks on one card stops before a world
   starts; then the enc-dec ``seamless-m4t-large-v2`` at full width and
   depth (24 + 24 layers) through ``--runtime table`` on a 1 x 4 mesh, 8
   microbatches of 2048 decoder tokens and 2048 encoder frames, 1f1b
   twice (1 step each, bitwise), its launches as ``table_launches``
   counts them;
   then the cell matrix (``phase_cells_path``, ROADMAP 18d):
   ``paper-gpt3-large`` x ``train_4k`` planned by ``launch.cells`` on
   1 x 4, its 256 rows cut to 8 microbatches of 1 x 4096, one step of
   ``build_cell``'s step function with ZeRO-1 AdamW, its loss and
   grad shards bit for bit ``build_trainer``'s executor's, launches as
   ``table_launches`` counts them; a mid stage's F and B timed against
   ``analysis/roofline.py``'s time for them (none may be faster); and the
   full-width stage re-layout 4 -> 2 -> 4 (live slots bitwise, the 4- and
   2-stage forwards bitwise);
   then ``repro_torch.launch.serve`` (full
   width, batch 8, cache 4096): ``seamless-m4t-large-v2`` for 32 tokens
   (the path of K3), ``zamba2-1.2b``, ``paper-gpt3-large``,
   ``deepseek-moe-16b`` (4 layers), ``xlstm-350m`` and ``qwen2-vl-2b`` on 4
   stages and ``grok-1-314b`` (2 layers, 2 stages) for 8.  The launch
   counts are zeroed just before each run and read just after; every
   kernel of the path must have launched in each, a serve run exactly as
   often as its layers give, and one more decode pass after a serve run
   must give finite logits; then serving on the in-process mesh
   (``phase_serve_mesh_path``, ROADMAP 18c): ``paper-gpt3-large`` on 2 x 4
   through ``launch.serve --devices 8`` (the 1 x 4 run's tokens and last
   hidden states), seamless on 2 x 4 with seeded ``xk``/``xv`` against its
   1 x 4 run (K3 from eight rank threads, a rerun bitwise),
   ``deepseek-moe-16b`` cut to 4 layers ``ep`` on 2 x 2 (``all_to_all`` as
   counted, a rerun bitwise) and ``gemma3-4b`` at full width and depth
   under ``sp_mode`` on 2 x 4 with its 131,072-token cache (65,536 rows a
   rank) against the unsharded 1 x 4 run from two positions, then the
   ``long_500k`` cell through ``launch.cells.build_cell`` on the same
   weights and caches (the ``sp_mode`` run's bits), each run's ms a step,
   peak memory, launches and collectives a step printed; then
   ``serve --procs`` (``phase_serve_procs_path``): ``paper-gpt3-large`` on
   2 x 4 as eight processes (gloo), every rank warmed at once, its tokens
   bit for bit the thread run's, its collectives a step and K2 launches
   summed over the processes the thread run's, each process's peak and
   the card's ``memory.used`` printed, ``--dist-backend nccl`` with 8
   ranks on one card stopping before a world starts; last, the examples
   (``phase_examples``): ``repro_torch.examples`` quickstart, serve_batch,
   train_lm (4 steps, its loss falling) and async_runtime on the card
   at the reference examples' sizes, each launching K1 and K2 as the code
   counts;
6. right after the language main paths (``phase_runtime_flags``), the
   runtime flags on paper-gpt3-large at full width cut to 4 layers (1 a
   stage): telemetry
   (``--metrics-report``, ``--explain``, ``--export-perfetto``, its step
   time against runs without it, in turns), a checkpoint write and
   ``--resume``, ``--recover`` from a killed stage (live params, then a
   checkpoint), and the adaptive hint loop, each held against its unfailed
   or uninterrupted run (bitwise, or within the spread of two identical
   runs, printed).  It needs about 4.5 GB of free disk under the temporary
   directory for one 3.2 GB checkpoint, removed at the end (and, earlier,
   21 GB for ``phase_procs_path``'s 18.9 GB one, removed before).

Each phase prints its wall time as it ends (``phase <name>: <s> s``), and
the run prints every phase, longest first, before its closing lines.

The last three lines are the card, the per-kernel JSON record and the
result JSON.  A copy of the record goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py TOL
TOL_LSE = 1e-4  # float32 log-sum-exp of either input dtype
#: (atol, rtol) of the SSD checks in tests/test_kernels.py
TOL_SSD = {"float32": (5e-4, 1e-5), "bfloat16": (6e-2, 3e-2)}
#: (b, sq, hq, hkv, hd, window): the main paths, then tests/test_kernels.py,
#: then every head dim at a ragged sq (not a multiple of 64 or 128), then
#: gemma3-4b's head_dim 256 (local window 1024, global, ragged), the
#: seamless decoder's, and gpt3's train_4k cell at seq 4096
ATTN_SHAPES = [
    (1, 2048, 16, 16, 96, 0),
    (1, 2048, 32, 32, 64, 0),
    (1, 2048, 12, 2, 128, 0),
    (1, 2048, 16, 16, 128, 0),
    (1, 2052, 12, 2, 128, 0),
    (1, 128, 4, 4, 64, 0),
    (2, 200, 8, 2, 64, 0),
    (1, 384, 8, 1, 128, 0),
    (2, 160, 4, 4, 64, 64),
    (1, 96, 4, 2, 32, 0),
    (1, 1000, 8, 2, 96, 0),
    (2, 333, 4, 4, 128, 0),
    (1, 777, 4, 1, 32, 256),
    (1, 1100, 4, 4, 64, 300),
    (1, 2048, 8, 4, 256, 1024),
    (1, 2048, 8, 4, 256, 0),
    (1, 1000, 8, 4, 256, 300),
    (1, 2048, 16, 16, 64, 0),
    (1, 4096, 16, 16, 96, 0),
]
#: K1 at the examples' shapes, float32 only (b, sq, hq, hkv, hd, window):
#: the reduced configs' head_dim 16, which only the float32 scalar kernel
#: takes (quickstart's 64-token rows, async_runtime's two rows of 16, a
#: windowed GQA case), and train_lm's heads of 64 at seq 128
EXAMPLE_ATTN_SHAPES = [(1, 64, 4, 4, 16, 0), (2, 16, 4, 4, 16, 0),
                       (1, 100, 4, 1, 16, 8), (1, 128, 4, 4, 64, 0)]
#: K1 with causal=False, (b, sq, sk, hq, hkv, hd): seamless's encoder and
#: cross-attention (2048 decoder tokens, 2048 encoder frames), a
#: cross-attention over fewer frames, the small table check's (256 tokens
#: against 384 frames), then ragged sq != sk shapes: GQA hd 96 (keys past
#: two 256-key blocks of the plain backward), more queries than keys (MQA
#: hd 128), hd 32 and hd 256
NONCAUSAL_SHAPES = [
    (1, 2048, 2048, 16, 16, 64),
    (1, 2048, 1536, 16, 16, 64),
    (1, 256, 384, 16, 16, 64),
    (2, 333, 517, 8, 2, 96),
    (1, 517, 333, 4, 1, 128),
    (1, 200, 777, 4, 2, 32),
    (1, 700, 1100, 8, 4, 256),
]
#: (b, s, nh, hd, ds, chunk): the zamba2 path, then tests/test_kernels.py
SSD_SHAPES = [
    (1, 2048, 64, 64, 64, 64),
    (2, 256, 4, 32, 16, 64),
    (1, 128, 8, 64, 64, 128),
    (1, 192, 2, 16, 8, 64),
    (2, 100, 2, 16, 8, 64),
]
#: (b, S, hq, hkv, hd, length, window): the seamless serve path's cross
#: attention (one micro-group against enc_len 1024), then tests/test_kernels.py
DECODE_SHAPES = [
    (1, 1024, 16, 16, 64, 1024, 0),
    (2, 300, 8, 2, 64, 157, 0),
    (1, 1024, 4, 1, 128, 1024, 0),
    (2, 512, 4, 4, 64, 300, 128),
    (1, 64, 2, 2, 32, 1, 0),
]
#: main path -> the shapes its kernels run at (timed at these, in bf16
#: unless an entry ends in its dtype's name)
PATH_SHAPES = {
    "paper-gpt3-large": {"attn": [ATTN_SHAPES[0]], "norm": [(2048, 1536)],
                         "ssd": []},
    "zamba2-1.2b": {"attn": [ATTN_SHAPES[1]],
                    "norm": [(2048, 2048), (2048, 4096)],
                    "ssd": [SSD_SHAPES[0]]},
    "seamless-m4t-large-v2 serve": {"attn": [], "norm": [(1, 1024)],
                                    "ssd": []},
    # the multimodal DAG: the text stage in bf16; the fusion and LM stages
    # (4 text slots + 2048 tokens) and the encoder in float32, as the
    # reference promotes a float32 activation meeting a bf16 weight
    "qwen2-vl-2b multimodal": {
        "attn": [(1, 2048, 12, 2, 128, 0),
                 (1, 2052, 12, 2, 128, 0, "float32")],
        "norm": [(2048, 1536), (2052, 1536, "float32"),
                 (48, 768, "float32"), (4096, 768, "float32")],
        "ssd": []},
    "gemma3-4b": {"attn": [(1, 2048, 8, 4, 256, 1024)], "norm": [],
                  "ssd": []},
    "deepseek-moe-16b": {"attn": [(1, 2048, 16, 16, 128, 0)],
                         "norm": [(2048, 2048)], "ssd": []},
    "qwen2-vl-2b": {"attn": [(1, 2048, 12, 2, 128, 0)],
                    "norm": [(2048, 1536)], "ssd": []},
    "xlstm-350m": {"attn": [], "norm": [(2048, 1024)], "ssd": []},
    "grok-1-314b serve": {"attn": [], "norm": [(1, 6144)], "ssd": []},
    # the decoder's causal self-attention (its non-causal encoder and
    # cross-attention are timed at NONCAUSAL_SHAPES[0]); 2048 rows of the
    # decoder tokens or of the encoder frames
    "seamless-m4t-large-v2 table": {"attn": [ATTN_SHAPES[-2]],
                                    "norm": [(2048, 1024)], "ssd": []},
    # the train_4k cell through launch/cells.build_cell (phase_cells_path)
    "paper-gpt3-large train_4k": {"attn": [ATTN_SHAPES[-1]],
                                  "norm": [(4096, 1536)], "ssd": []},
    # the examples (phase_examples): reduced configs, float32; train_lm's
    # d 256
    "examples": {"attn": [EXAMPLE_ATTN_SHAPES[0] + ("float32",),
                          EXAMPLE_ATTN_SHAPES[-1] + ("float32",)],
                 "norm": [(64, 64, "float32"), (128, 256, "float32")],
                 "ssd": []},
}

COMMON_ARGS = ["--runtime", "actor", "--full-size", "--stages", "4",
               "--microbatches", "8", "--mb-rows", "1", "--seq", "2048",
               "--device", "cuda"]
BFW = ["--hint", "bfw", "--split-backward"]
#: (arch, [(run name, extra flags)], kernels every run must launch, layers:
#: None for the full depth, else the full-width config cut to that many,
#: ``registry.cut_depth``, through ``train_actor(args, cfg=...)``)
MAIN_PATHS = [
    ("paper-gpt3-large",
     [("bf", ["--steps", "2", "--hint", "bf"]),
      ("bfw", ["--steps", "1"] + BFW)],
     ("flash_attention_fwd", "flash_attention_bwd", "rmsnorm"), None),
    # cut to 20 layers (5 a stage, 4 shared-block applications)
    ("zamba2-1.2b",
     [("bf", ["--steps", "1", "--hint", "bf"]),
      ("bfw", ["--steps", "1"] + BFW)],
     ("flash_attention_fwd", "flash_attention_bwd", "rmsnorm", "ssd_scan"),
     20),
    # the dense first layer and 3 MoE layers, one per stage: 2.27e9
    # parameters at ~14 B each on the card (bf16 weights and grads, float32
    # m and v); the 28 layers do not fit one card
    ("deepseek-moe-16b",
     [("bf", ["--steps", "1", "--hint", "bf"]),
      ("bfw", ["--steps", "1"] + BFW)],
     ("flash_attention_fwd", "flash_attention_bwd", "rmsnorm"), 4),
    # the language workload: embeddings in, M-RoPE positions (synth_batch's
    # three equal streams), cut from 28 layers to 16 (4 a stage)
    ("qwen2-vl-2b",
     [("bf", ["--steps", "1", "--hint", "bf"]),
      ("bfw", ["--steps", "1"] + BFW)],
     ("flash_attention_fwd", "flash_attention_bwd", "rmsnorm"), 16),
    # 7 mLSTM + 1 sLSTM layers (the 7:1 pattern's first block), bf for 1
    # step of 2 microbatches: the sLSTM's time loop is host-bound and runs
    # once a microbatch, 51-58 s a step of 8 with one sLSTM layer on one
    # H100 80GB HBM3 at 700 W (bfw 89 s); the full depth holds three, and
    # a stage waited past the 120 s deadlock guard
    ("xlstm-350m",
     [("bf", ["--steps", "1", "--hint", "bf", "--microbatches", "2"])],
     ("rmsnorm",), 8),
]
#: the multimodal DAG (qwen2-vl-2b full width, 2 layers per stage: 1
#: encoder stage, the text stage, fusion + 1 LM stage) through the launcher
MM_ARGS = ["--workload", "multimodal", "--arch", "qwen2-vl-2b"] + COMMON_ARGS
MM_RUNS = [("bf", ["--steps", "2", "--hint", "bf"]),
           ("bfw", ["--steps", "1"] + BFW)]
#: the reference launcher's full-size encoder settings for its cost model
#: (repro/launch/train.py:217-220): the real-encoder run's config
MM_REAL_ENCODER = dict(text_seq=512, mean_enc_tokens=2048,
                       buckets=(1024, 2048, 4096))
SERVE_ARGS = ["--full-size", "--stages", "4", "--batch", "8", "--cache-len",
              "4096", "--device", "cuda"]
#: (arch, tokens, layers, stages): the serve runs (layers None: full
#: depth; else ``registry.cut_depth``); each must launch its kernels exactly
#: as often as ``serve_launches`` counts from its layers.  grok-1-314b has
#: 4.9e9 parameters a layer: 2 layers in bf16 on 2 stages (~23 GB)
SERVE_PATHS = [("seamless-m4t-large-v2", 32, None, 4),
               ("zamba2-1.2b", 8, None, 4), ("paper-gpt3-large", 8, None, 4),
               ("deepseek-moe-16b", 8, 4, 4), ("grok-1-314b", 8, 2, 2),
               ("xlstm-350m", 8, None, 4), ("qwen2-vl-2b", 8, None, 4)]


def check_no_spills(log: str, entry: str) -> int:
    """ptxas's verbose log: every instantiation whose name holds ``entry``
    must report 0 bytes of spill stores and loads.  Returns how many."""
    import re

    found = re.findall(r"Function properties for (\S+)\n\s*(\d+) bytes "
                       r"stack frame, (\d+) bytes spill stores, (\d+) bytes "
                       r"spill loads", log)
    hits = [(name, int(st), int(ld)) for name, _, st, ld in found
            if entry in name]
    if not hits:
        raise AssertionError(f"no {entry} instantiation in the build log")
    bad = [h for h in hits if h[1] or h[2]]
    if bad:
        raise AssertionError(f"ptxas spills in {bad}")
    return len(hits)


def card(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters: int = 20, reps: int = 3) -> float:
    """Device ms per call: ``iters`` calls cycling through ``arg_sets``
    (distinct inputs, so a call does not find the previous one's in L2) are
    captured in a CUDA graph and replayed ``reps`` times between two
    events, so the host's launch cost is not in the number.  Warm-up and
    capture share one stream (K3's arrival counters are per stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:  # compile, autotune, warm the allocator
            fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def time_events_ms(fn, arg_sets, iters: int = 20) -> float:
    """Device ms per call between two events, for a call that is not
    captured in a CUDA graph (an autograd backward kept for reuse): a
    spinning kernel holds the stream while the host enqueues the calls, so
    the host's launch cost is not in the number; warm-up first."""
    import torch

    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clocks
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, tol, rtol=None) -> float:
    import torch

    rtol = tol if rtol is None else rtol
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=rtol)
    print(f"  {name}: max |err| {err:.3e}  (tolerance atol={tol:g} "
          f"rtol={rtol:g})  {'ok' if ok else 'FAIL'}")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max |err| {err:.3e} > {tol:g})")
    return err


def same_bits(name, got, want) -> None:
    """Two launches on the same inputs must give the same bits."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the bits differ from the first")
    print(f"  {name}: bit-identical")


def expect_raise(name, fn, exc) -> None:
    try:
        fn()
    except exc as e:
        print(f"  {name}: raises {type(e).__name__} ({str(e)[:60]}...)")
        return
    raise AssertionError(f"{name}: did not raise {exc.__name__}")


def bound(flops, peak_flops, nbytes):
    """(bound ms, what bounds it): the larger of operations over the peak
    rate for their type and bytes over the memory rate."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def kernel_entry(name, route, source, replaces, timings):
    """The kernel's JSON record: its first main-path shape's numbers at the
    top level, every main-path shape's under ``by_shape``."""
    top = {k: v for k, v in timings[0].items() if k not in ("path", "shape")}
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, **top, "by_shape": timings}


def attention_inputs(shape, dtype, seed):
    """Pre-scaled q and k, v in the model's [b, s, h, hd] storage, viewed as
    the kernel's [b, h, s, hd] (the main path's strides)."""
    b, sq, hq, hkv, hd, _ = shape
    return noncausal_inputs((b, sq, sq, hq, hkv, hd), dtype, seed)


def noncausal_inputs(shape, dtype, seed):
    """attention_inputs' tensors for sq queries against sk keys (shape
    (b, sq, sk, hq, hkv, hd))."""
    import torch

    b, sq, sk, hq, hkv, hd = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, hq, hd), generator=g, device="cuda") * hd ** -0.5
    k = torch.randn((b, sk, hkv, hd), generator=g, device="cuda")
    v = torch.randn((b, sk, hkv, hd), generator=g, device="cuda")
    return tuple(t.to(dtype).transpose(1, 2) for t in (q, k, v))


def phase_attention_noncausal(timings):
    """K1 with causal=False at NONCAUSAL_SHAPES, float32 and bf16: out and
    lse against the plain version, a second launch bitwise; the plain
    backward (``flash_attention_bwd_plain``, fed the kernel's out and lse
    as in training) against autograd of the plain forward; then the
    seamless shape's time beside SDPA's (no mask) and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    print("K1 flash_attention_fwd causal=False (the enc-dec encoder and "
          "cross-attention) vs its plain version:")
    errs = {}
    for shape in NONCAUSAL_SHAPES:
        b, sq, sk, hq, hkv, hd = shape
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            q, k, v = noncausal_inputs(shape, dtype, seed=hash(shape) % 2**31)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=False)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v,
                                                          causal=False)
            tag = f"b{b} sq{sq} sk{sk} hq{hq} hkv{hkv} hd{hd} non-causal {dn}"
            errs[shape, dn] = check_close(f"{tag} out", out, want, TOL[dn])
            check_close(f"{tag} lse", lse, want_lse, TOL_LSE)
            again, lse2 = fa.flash_attention_fwd(q, k, v, causal=False)
            same_bits(f"{tag} second launch", (out, lse), (again, lse2))
            dout = torch.randn(out.shape, device="cuda").to(dtype)
            got = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                               causal=False)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o, _ = fa.flash_attention_fwd_plain(*leaves, causal=False)
            want_g = torch.autograd.grad(o, leaves, dout)
            for name, a, w in zip(("dq", "dk", "dv"), got, want_g):
                # bf16: the plain backward rounds p and ds to bf16 (the
                # reference's rounding points), autograd keeps them float32,
                # and a sum over keys may cancel: relative to max |grad|
                tol, rtol = ((TOL[dn], None) if dn == "float32" else
                             (TOL[dn] * float(w.abs().max()), 0.0))
                check_close(f"{tag} plain backward {name} vs autograd", a, w,
                            tol, rtol)
            del out, lse, want, want_lse, got, want_g, leaves, o
    shape = NONCAUSAL_SHAPES[0]
    b, sq, sk, hq, hkv, hd = shape
    sets = [noncausal_inputs(shape, torch.bfloat16, seed=s)
            for s in range(4)]
    ms = time_ms(lambda q, k, v: fa.flash_attention_fwd(q, k, v,
                                                        causal=False), sets)
    plain_ms = time_ms(lambda q, k, v: fa.flash_attention_fwd_plain(
        q, k, v, causal=False), sets, iters=4)
    lib_sets = [tuple(t.contiguous() for t in s) for s in sets]
    lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, scale=1.0, enable_gqa=hq != hkv), lib_sets)
    flops = 4 * b * hq * sq * sk * hd  # QK^T + PV over every pair
    nbytes = (2 * b * sq * hq * hd + 2 * b * sk * hkv * hd) * 2 \
        + b * hq * sq * 4
    bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    path = "seamless-m4t-large-v2 table"
    print(f"  {path} non-causal shape {shape} bfloat16: kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP / 989 TFLOP/s, "
          f"{nbytes:.4g} B / 3.35 TB/s)")
    timings.append({"path": path, "shape": list(shape), "causal": False,
                    "dtype": "bfloat16",
                    "max_abs_err": errs[shape, "bfloat16"], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})


def phase_attention(record):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    print("K1 flash_attention_fwd (CUDA) vs its plain version:")
    errs = {}
    for shape in ATTN_SHAPES:
        window = shape[5]
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            q, k, v = attention_inputs(shape, dtype, seed=hash(shape) % 2**31)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                              window=window)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_fwd_plain(
                q, k, v, causal=True, window=window)
            tag = f"b{shape[0]} s{shape[1]} hq{shape[2]} hkv{shape[3]} " \
                  f"hd{shape[4]} w{window} {dn}"
            errs[shape, dn] = check_close(f"{tag} out", out, want, TOL[dn])
            check_close(f"{tag} lse", lse, want_lse, TOL_LSE)
            again, lse2 = fa.flash_attention_fwd(q, k, v, causal=True,
                                                 window=window)
            same_bits(f"{tag} second launch", (out, lse), (again, lse2))
    for shape in EXAMPLE_ATTN_SHAPES:  # float32 only
        window = shape[5]
        q, k, v = attention_inputs(shape, torch.float32,
                                   seed=hash(shape) % 2**31)
        out, lse = fa.flash_attention_fwd(q, k, v, window=window)
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, window=window)
        tag = f"b{shape[0]} s{shape[1]} hq{shape[2]} hkv{shape[3]} " \
              f"hd{shape[4]} w{window} float32"
        errs[shape, "float32"] = check_close(f"{tag} out", out, want,
                                             TOL["float32"])
        check_close(f"{tag} lse", lse, want_lse, TOL_LSE)
        again, lse2 = fa.flash_attention_fwd(q, k, v, window=window)
        same_bits(f"{tag} second launch", (out, lse), (again, lse2))
    q, k, v = attention_inputs(EXAMPLE_ATTN_SHAPES[0], torch.bfloat16, seed=1)
    expect_raise("K1 bf16 at head_dim 16 (the float32 kernel's only)",
                 lambda: fa.flash_attention_fwd(q, k, v), ValueError)
    # the bf16 kernel's 16-byte copies refuse a view off 16-byte alignment
    b, sq, hq, hkv, hd, _ = ATTN_SHAPES[0]
    q, k, v = attention_inputs(ATTN_SHAPES[0], torch.bfloat16, seed=1)
    wide = torch.zeros((b, sq, hq, hd + 8), dtype=torch.bfloat16,
                       device="cuda")
    off = wide[..., 4:4 + hd].transpose(1, 2)  # 8 bytes past alignment
    off.copy_(q)
    expect_raise("K1 on a misaligned q view",
                 lambda: fa.flash_attention_fwd(off, k, v), ValueError)
    timings = []
    for path, shapes in PATH_SHAPES.items():
        for entry in shapes["attn"]:
            shape, dn = entry[:6], (entry[6:] or ("bfloat16",))[0]
            dtype = getattr(torch, dn)
            b, sq, hq, hkv, hd, window = shape
            sets = [attention_inputs(shape, dtype, seed=s) for s in range(4)]
            ms = time_ms(lambda q, k, v: fa.flash_attention_fwd(
                q, k, v, window=window), sets)
            plain_ms = time_ms(lambda q, k, v: fa.flash_attention_fwd_plain(
                q, k, v, window=window), sets, iters=4)
            # one SDPA call on the same function: causal, or a boolean mask
            # for the window; GQA by its kv-head broadcast
            pos = torch.arange(sq, device="cuda")
            mask = None if window == 0 else (
                (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None]
                                               < window))
            lib_sets = [tuple(t.contiguous() for t in s) for s in sets]
            lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None, scale=1.0,
                enable_gqa=hq != hkv), lib_sets)
            # QK^T + PV over the unmasked (query, key) pairs of this shape
            pairs = sum(min(i + 1, window or sq) for i in range(sq))
            flops = 4 * b * hq * pairs * hd
            size = dtype.itemsize
            nbytes = (2 * b * sq * hq * hd + 2 * b * sq * hkv * hd) * size \
                + b * hq * sq * 4
            peak = PEAK_BF16_FLOPS if dn == "bfloat16" else PEAK_FP32_FLOPS
            bound_ms, bound_by = bound(flops, peak, nbytes)
            print(f"  {path} shape {shape} {dn}: kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP / "
                  f"{peak / 1e12:g} TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)")
            timings.append({"path": path, "shape": list(shape), "dtype": dn,
                            "max_abs_err": errs[shape, dn], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib_ms})
    phase_attention_noncausal(timings)
    record["flash_attention_fwd"] = kernel_entry(
        "flash_attention_fwd", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:79", timings)


def attention_bwd_inputs(shape, dtype, seed):
    """noncausal_inputs' q, k, v (any sq, sk), the kernel forward's out and
    lse on them, and a dout, all in the model's layout."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    shape, causal, window = shape[:6], shape[6], shape[7]
    q, k, v = noncausal_inputs(shape, dtype, seed)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dout = torch.randn(out.transpose(1, 2).shape, generator=g,
                       device="cuda").to(dtype).transpose(1, 2)
    return q, k, v, out, lse, dout


def phase_attention_bwd(record):
    """K1b (``flash_attention_bwd``) against ``flash_attention_bwd_plain``
    in bf16, fed the forward kernel's out and lse: every ATTN_SHAPES entry
    (causal, windows, each head dim, GQA) and NONCAUSAL_SHAPES, a second
    launch bitwise, one count a call; float32 on the plain route, counting
    nothing; then at each main path's bf16 shape its time beside the plain
    backward's, the backward of one SDPA call and its bound (the five
    products of the unmasked pairs, 2.5 x K1's FLOPs)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    print("K1b flash_attention_bwd (CUDA, bf16) vs the plain backward:")
    cases = ([(b, s, s, hq, hkv, hd, True, w)
              for b, s, hq, hkv, hd, w in ATTN_SHAPES]
             + [shape + (False, 0) for shape in NONCAUSAL_SHAPES])
    errs = {}
    for case in cases:
        b, sq, sk, hq, hkv, hd, causal, window = case
        q, k, v, out, lse, dout = attention_bwd_inputs(
            case, torch.bfloat16, seed=hash(case) % 2**31)
        ops.reset_launch_counts()
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                     window=window, dq_scale=0.5)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                            causal=causal, window=window,
                                            dq_scale=0.5)
        tag = (f"b{b} sq{sq} sk{sk} hq{hq} hkv{hkv} hd{hd} "
               f"{'causal' if causal else 'non-causal'} w{window}")
        errs[case] = max(check_close(f"{tag} {name}", a, w, TOL["bfloat16"])
                         for name, a, w in zip(("dq", "dk", "dv"), got,
                                               want))
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       dq_scale=0.5)
        same_bits(f"{tag} second launch", got, again)
        if ops.launch_counts()["flash_attention_bwd"] != 2:
            raise AssertionError(f"{tag}: counted "
                                 f"{ops.launch_counts()}, not 2 calls")
        del got, want, again, q, k, v, out, lse, dout
    q, k, v, out, lse, dout = attention_bwd_inputs(
        cases[0], torch.float32, seed=1)
    ops.reset_launch_counts()
    same_bits("float32: the plain backward itself",
              fa.flash_attention_bwd(q, k, v, out, lse, dout),
              fa.flash_attention_bwd_plain(q, k, v, out, lse, dout))
    if ops.launch_counts()["flash_attention_bwd"]:
        raise AssertionError("a float32 backward counted a kernel call")
    del q, k, v, out, lse, dout
    timings = []
    for path, shapes in PATH_SHAPES.items():
        for entry in shapes["attn"]:
            if entry[6:] and entry[6] != "bfloat16":
                continue
            b, sq, hq, hkv, hd, window = entry[:6]
            case = (b, sq, sq, hq, hkv, hd, True, window)
            sets = [attention_bwd_inputs(case, torch.bfloat16, seed=s)
                    for s in range(4)]
            ms = time_ms(lambda q, k, v, o, lse, do: fa.flash_attention_bwd(
                q, k, v, o, lse, do, window=window), sets)
            plain_ms = time_ms(
                lambda q, k, v, o, lse, do: fa.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, window=window), sets, iters=2)
            # one SDPA call's backward on the same function, from a graph
            # kept for it: causal, or a boolean mask for the window
            pos = torch.arange(sq, device="cuda")
            mask = None if window == 0 else (
                (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None]
                                               < window))
            lib = []
            for q, k, v, _, _, do in sets:
                leaves = [t.contiguous().requires_grad_() for t in (q, k, v)]
                o = F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask, is_causal=mask is None,
                    scale=1.0, enable_gqa=hq != hkv)
                lib.append((o, leaves, do.contiguous()))
            lib_ms = time_events_ms(lambda o, leaves, do: torch.autograd.grad(
                o, leaves, do, retain_graph=True), lib)
            pairs = sum(min(i + 1, window or sq) for i in range(sq))
            flops = 10 * b * hq * pairs * hd
            nbytes = (4 * b * sq * hq * hd + 4 * b * sq * hkv * hd) * 2 \
                + b * hq * sq * 4
            bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
            print(f"  {path} shape {entry[:6]} bfloat16: kernel {ms:.4f} ms"
                  f"  plain {plain_ms:.4f} ms  sdpa backward {lib_ms:.4f} "
                  f"ms  bound {bound_ms:.4f} ms ({bound_by}: {flops:.4g} "
                  f"FLOP / 989 TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)")
            timings.append({"path": path, "shape": list(entry[:6]),
                            "dtype": "bfloat16", "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib_ms,
                            "max_abs_err": errs.get(case)})
            del sets, lib
    record["flash_attention_bwd"] = kernel_entry(
        "flash_attention_bwd", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "none (the reference's XLA VJP, repro/models/layers.py "
        "_blocked_attention_bwd)", timings)


def phase_rmsnorm(record):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    print("K2 rmsnorm (Triton) vs its plain version:")
    g = torch.Generator(device="cuda").manual_seed(7)
    timings = []
    for path, shapes in PATH_SHAPES.items():
        for entry in shapes["norm"]:
            (rows, d), tdn = entry[:2], (entry[2:] or ("bfloat16",))[0]
            tdtype = getattr(torch, tdn)
            err = {}
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                x = torch.randn((rows, d), generator=g,
                                device="cuda").to(dtype)
                scale = (torch.randn((d,), generator=g, device="cuda")
                         * 0.1).to(dtype)
                got = rn.rmsnorm(x, scale)
                torch.cuda.synchronize()
                err[dn] = check_close(f"[{rows}, {d}] {dn}", got,
                                      rn.rmsnorm_plain(x, scale), TOL[dn])
            # the model's float32 activations meet a bf16 scale
            x = torch.randn((rows, d), generator=g, device="cuda")
            scale = (torch.randn((d,), generator=g, device="cuda")
                     * 0.1).bfloat16()
            got = rn.rmsnorm(x, scale)
            torch.cuda.synchronize()
            check_close(f"[{rows}, {d}] float32 x, bfloat16 scale", got,
                        rn.rmsnorm_plain(x, scale), TOL["float32"])
            # more distinct inputs than the 50 MB L2 holds, up to one per
            # timed call (a [1, d] row stays L2-resident, as in the model)
            size = tdtype.itemsize
            n_sets = min(64, max(4, (2 * 50 * 2**20) // (rows * d * size)
                                 + 1))
            sets = []
            for _ in range(n_sets):
                x = torch.randn((rows, d), generator=g,
                                device="cuda").to(tdtype)
                sets.append((x, (torch.randn((d,), generator=g, device="cuda")
                                 * 0.1).to(torch.bfloat16)))
            ms = time_ms(lambda x, s: rn.rmsnorm(x, s), sets, iters=64)
            plain_ms = time_ms(lambda x, s: rn.rmsnorm_plain(x, s), sets,
                               iters=64)
            lib_ms = time_ms(lambda x, s, d=d: F.rms_norm(
                x, (d,), weight=1.0 + s.to(x.dtype), eps=1e-5), sets,
                iters=64)
            nbytes = 2 * rows * d * size + d * 2
            flops = 4 * rows * d
            bound_ms, bound_by = bound(flops, PEAK_FP32_FLOPS, nbytes)
            print(f"  {path} [{rows}, {d}] {tdn}: kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  F.rms_norm {lib_ms:.4f} ms  bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {nbytes:.4g} B / 3.35 "
                  f"TB/s, {flops:.4g} FLOP / 67 TFLOP/s)")
            timings.append({"path": path, "shape": [rows, d], "dtype": tdn,
                            "max_abs_err": err[tdn], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib_ms})
    record["rmsnorm"] = kernel_entry(
        "rmsnorm", "triton", "src/repro_torch/kernels/rmsnorm.py",
        "src/repro/kernels/rmsnorm.py:19", timings)


def ssd_inputs(shape, dtype, bc_dtype, seed):
    """The reference tests' SSD inputs; x, B and C are views of one
    ``[b, s, nh*hd + 2*ds]`` buffer, as the model slices its ``xbc``."""
    import torch

    b, s, nh, hd, ds, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn((b, s, nh * hd + 2 * ds), generator=g,
                      device="cuda").to(dtype)
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    bc = xbc[..., nh * hd:].to(bc_dtype)  # still a view when of x's dtype
    B, C = bc[..., :ds], bc[..., ds:]
    dt = torch.randn((b, s, nh), generator=g, device="cuda").abs() * 0.1
    A = -torch.randn((nh,), generator=g, device="cuda").abs()
    D = torch.randn((nh,), generator=g, device="cuda")
    return x, dt, A, B, C, D


def phase_ssd(record):
    """K4 against its plain version run on float32 copies of the same
    inputs and cast back (the Pallas kernel's float32 arithmetic), and at
    the reference tests' shapes also against the sequential oracle.  bf16
    x takes the tensor-core kernel (float32 B and C cast to bf16 by the
    wrapper), float32 x the scalar one; every check launches twice and
    requires the same bits, and the bf16 kernel must refuse a view off
    16-byte alignment."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd

    print("K4 ssd_scan (CUDA; bf16: tensor cores, float32: scalar) vs its "
          "plain version:")
    errs = {}
    for shape in SSD_SHAPES:
        chunk = shape[5]
        main = shape in PATH_SHAPES["zamba2-1.2b"]["ssd"]
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            # the main path's B and C are bf16; the tests' are float32
            bc_dtype = dtype if main else torch.float32
            x, dt, A, B, C, D = ssd_inputs(shape, dtype, bc_dtype,
                                           seed=hash(shape) % 2**31)
            got = ops.ssd(x, dt, A, B, C, D, chunk=chunk)  # pads s = 100
            torch.cuda.synchronize()
            want = ssd.ssd_chunked_plain(x.float(), dt, A, B.float(),
                                         C.float(), D, chunk).to(dtype)
            atol, rtol = TOL_SSD[dn]
            tag = f"b{shape[0]} s{shape[1]} nh{shape[2]} hd{shape[3]} " \
                  f"ds{shape[4]} chunk{chunk} {dn}"
            errs[shape, dn] = check_close(tag, got, want, atol, rtol)
            if not main:
                check_close(f"{tag} vs ssd_ref", got,
                            ref.ssd_ref(x, dt, A, B, C, D), atol, rtol)
            same_bits(f"{tag} second launch", (got,),
                      (ops.ssd(x, dt, A, B, C, D, chunk=chunk),))
    # the bf16 kernel's 16-byte copies refuse a view off 16-byte alignment
    b, s, nh, hd, ds, chunk = SSD_SHAPES[0]
    x, dt, A, B, C, D = ssd_inputs(SSD_SHAPES[0], torch.bfloat16,
                                   torch.bfloat16, seed=1)
    wide = torch.zeros((b, s, nh * hd + 8), dtype=torch.bfloat16,
                       device="cuda")
    off = wide[..., 4:4 + nh * hd].reshape(b, s, nh, hd)  # 8 bytes off
    off.copy_(x)
    expect_raise("K4 on a misaligned x view",
                 lambda: ssd.ssd_scan(off, dt, A, B, C, D, chunk=chunk),
                 ValueError)
    timings = []
    for shape in PATH_SHAPES["zamba2-1.2b"]["ssd"]:
        b, s, nh, hd, ds, chunk = shape
        per_set = b * s * (nh * hd + 2 * ds) * 2 + b * s * nh * 4
        sets = [ssd_inputs(shape, torch.bfloat16, torch.bfloat16, seed=i)
                for i in range(50 * 2**20 // per_set + 2)]  # more than L2
        ms = time_ms(lambda *a: ssd.ssd_scan(*a, chunk=chunk), sets)
        plain_ms = time_ms(lambda *a: ssd.ssd_chunked_plain(*a, chunk), sets,
                           iters=4)
        nc = s // chunk
        flops = 2 * b * nh * nc * (chunk * chunk * ds + chunk * chunk * hd
                                   + 2 * chunk * ds * hd)
        nbytes = 2 * b * s * nh * hd * 2 + 2 * b * s * ds * 2 \
            + b * s * nh * 4 + 2 * nh * 4
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
        print(f"  zamba2-1.2b shape {shape} bf16: kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  library: none  bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes:.4g} B / 3.35 TB/s, {flops:.4g} FLOP / "
              f"989 TFLOP/s); achieved {nbytes / ms * 1e-9:.4g} TB/s, "
              f"{flops / ms * 1e-9:.4g} TFLOP/s, {bound_ms / ms:.1%} of the "
              f"bound")
        timings.append({"path": "zamba2-1.2b", "shape": list(shape),
                        "max_abs_err": errs[shape, "bfloat16"], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    record["ssd_scan"] = kernel_entry(
        "ssd_scan", "cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:56", timings)


def decode_inputs(shape, dtype, seed):
    """q [b, 1, hq, hd] and k, v caches [b, S, hkv, hd] in the model's
    layout; and q pre-scaled with the caches viewed as the kernel's
    [b, h, S, hd] (the main path's strides)."""
    import torch

    b, S, hq, hkv, hd, _, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, hq, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, S, hkv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, S, hkv, hd), generator=g, device="cuda").to(dtype)
    qs = (q * hd ** -0.5).to(dtype).transpose(1, 2)
    return (q, k, v), (qs, k.transpose(1, 2), v.transpose(1, 2))


def phase_decode(record):
    """K3 against its plain version on the same inputs (the wrapper the
    model calls, ``ops.decode_attention``), one CUDA graph replayed at
    three lengths, calls on two streams at once, then its time at the serve
    shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops, ref

    print("K3 flash_decode (CUDA) vs its plain version:")
    errs = {}
    for shape in DECODE_SHAPES:
        b, S, hq, hkv, hd, length, window = shape
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            (q, k, v), (qs, kt, vt) = decode_inputs(shape, dtype,
                                                    seed=hash(shape) % 2**31)
            got = ops.decode_attention(q, k, v, length, window=window)
            torch.cuda.synchronize()
            want = fd.flash_decode_plain(qs, kt, vt, length, window=window)
            tag = (f"b{b} S{S} hq{hq} hkv{hkv} hd{hd} length{length} "
                   f"w{window} {dn}")
            errs[shape, dn] = check_close(tag, got, want.transpose(1, 2),
                                          TOL[dn])
            same_bits(f"{tag} second launch", (got,),
                      (ops.decode_attention(q, k, v, length, window=window),))
    (q, k, v), (qs, kt, vt) = decode_inputs(DECODE_SHAPES[0], torch.bfloat16,
                                            seed=1)
    wide = torch.zeros(q.shape[:-1] + (q.shape[-1] + 8,), dtype=q.dtype,
                       device="cuda")
    off = wide[..., 4:4 + q.shape[-1]].transpose(1, 2)  # 8 bytes off
    off.copy_(qs)
    expect_raise("K3 on a misaligned q view",
                 lambda: fd.flash_decode(off, kt, vt, DECODE_SHAPES[0][5]),
                 ValueError)

    # tests/test_kernels.py::test_decode_length_is_dynamic on the card: one
    # captured launch sequence serves every length written into the tensor
    shape = (1, 256, 4, 2, 32, 256, 0)
    (q, k, v), (qs, kt, vt) = decode_inputs(shape, torch.float32, seed=3)
    len_t = torch.full((1,), 256, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()  # warm-up on the capture stream: its counters
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fd.flash_decode(qs, kt, vt, len_t)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fd.flash_decode(qs, kt, vt, len_t)
    for length in (1, 100, 256):
        len_t.fill_(length)
        graph.replay()
        torch.cuda.synchronize()
        lengths = torch.full((1,), length, device="cuda")
        check_close(f"one graph, length {length} vs decode_ref",
                    out.transpose(1, 2), ref.decode_ref(q, k, v, lengths),
                    TOL["float32"])
        # a replay that finds its arrival counters left at 0 merges again
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        same_bits(f"one graph, length {length}, second replay", (out,),
                  (first,))

    # calls on two streams at once take separate arrival counters: each
    # gives the bits of the same call alone
    shape = DECODE_SHAPES[0]
    length = shape[5]
    _, (qs, kt, vt) = decode_inputs(shape, torch.bfloat16, seed=5)
    alone = fd.flash_decode(qs, kt, vt, length)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(50):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(fd.flash_decode(qs, kt, vt, length))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    same_bits(f"{len(outs)} calls interleaved on two streams", outs,
              (alone,) * len(outs))

    timings = []
    b, S, hq, hkv, hd, length, _ = shape
    per_set = 2 * b * S * hkv * hd * 2
    sets = [decode_inputs(shape, torch.bfloat16, seed=i)[1]
            for i in range(50 * 2**20 // per_set + 2)]  # more than L2 holds
    len_t = torch.full((1,), length, dtype=torch.int32, device="cuda")
    ms = time_ms(lambda q, k, v: fd.flash_decode(q, k, v, length), sets)
    plain_ms = time_ms(lambda q, k, v: fd.flash_decode_plain(q, k, v, len_t),
                       sets)
    lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, scale=1.0), sets)
    nbytes = 2 * b * length * hkv * hd * 2 + 2 * b * hq * hd * 2
    flops = 4 * b * hq * length * hd
    bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    print(f"  seamless serve shape {shape} bf16: kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bound_ms:.5f} ms "
          f"({bound_by}: {nbytes:.4g} B / 3.35 TB/s, {flops:.4g} FLOP / "
          f"989 TFLOP/s)")
    timings.append({"path": "seamless-m4t-large-v2 serve",
                    "shape": list(shape),
                    "max_abs_err": errs[shape, "bfloat16"], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})
    record["flash_decode"] = kernel_entry(
        "flash_decode", "cuda", "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:68", timings)


#: the values drawn_on_card has drawn
DRAWN = {"values": 0}


def drawn_on_card(make):
    """``make(device)``, a seeded init (a module or a list of modules), run
    on the card and moved to the host.  A card-vs-CPU check needs the same
    weights on both sides, not the host generator's stream, and at full
    width drawing them on the host took most of a small phase's time
    (``host_draw_seconds`` prints what it would take)."""
    out = make("cuda")
    for m in out if isinstance(out, list) else [out]:
        m.to("cpu")
        DRAWN["values"] += sum(p.numel() for p in m.parameters())
    return out


def host_draw_seconds(n: int = 50_000_000) -> float:
    """The seconds the host would take to draw the small phases' weights
    (``DRAWN``) with the models' own draw (``torch.randn`` from a seeded
    generator, float32), timed on ``n`` values here; printed."""
    import torch

    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    torch.randn((n,), generator=gen, dtype=torch.float32)
    rate = n / (time.perf_counter() - t0)
    secs = DRAWN["values"] / rate
    print(f"the small phases drew {DRAWN['values']:,} weight values on the "
          f"card; this host draws {rate:,.0f} a second (timed on {n:,}), so "
          f"drawing them here would have taken at least {secs:.1f} s")
    return secs


def small_config(arch: str, layers: int):
    import dataclasses

    import torch

    from repro_torch.configs import registry

    cfg = registry.get_arch(arch)
    pattern = (None if cfg.layer_pattern is None
               else cfg.layer_pattern[:layers])
    return dataclasses.replace(cfg, num_layers=layers, layer_pattern=pattern,
                               dtype=torch.float32)


#: (arch, layers, tokens) of the small-input forwards
SMALL_MODELS = [("paper-gpt3-large", 2, 256), ("zamba2-1.2b", 3, 256),
                ("gemma3-4b", 6, 256), ("deepseek-moe-16b", 2, 256),
                ("xlstm-350m", 8, 320), ("qwen2-vl-2b", 2, 256)]


def small_inputs(cfg, s: int) -> tuple[dict, dict]:
    """CPU (batch, aux) of one row of ``s`` tokens: token ids or, for an
    ``embed_input`` arch, embeddings; three distinct M-RoPE streams (a
    time index and a patch grid) for an M-RoPE arch."""
    import torch

    rng = torch.Generator().manual_seed(5)
    batch = ({"embeds": torch.randn((1, s, cfg.d_model), generator=rng)}
             if cfg.embed_input else
             {"tokens": torch.randint(0, cfg.vocab_size, (1, s),
                                      generator=rng)})
    aux = {"positions": torch.arange(s)[None]}
    if cfg.mrope:
        aux["mrope"] = torch.stack([
            torch.arange(s)[None] // 4,
            torch.randint(0, 16, (1, s), generator=rng),
            torch.randint(0, 16, (1, s), generator=rng)])
    return batch, aux


def phase_small_model():
    """The port's forward on the card (kernels) against the CPU (plain
    versions) on identical weights, float32, full widths (SMALL_MODELS):
    paper-gpt3-large with 2 layers; zamba2-1.2b with 3 Mamba layers on 2
    stages (a shared-block slot and a disabled slot); gemma3-4b with 6
    layers, five local and one global (K1 at head_dim 256);
    deepseek-moe-16b's dense and first MoE layer; xlstm-350m's first 8
    layers (7 mLSTM, 1 sLSTM) at 320 tokens, past the parallel form's 256
    (the chunked form); qwen2-vl-2b with 2 layers, embeddings in and three
    distinct M-RoPE streams."""
    import copy

    import torch

    from repro_torch.models.build import build

    print("small-input forward, card (kernels) vs CPU (plain), float32:")
    for arch, layers, s in SMALL_MODELS:
        cfg = small_config(arch, layers)
        model = build(cfg, num_stages=2)
        sp_cpu = [drawn_on_card(lambda d, i=i: model.init_stage_params(
            i, seed=3, device=d)) for i in range(2)]
        io_cpu = drawn_on_card(lambda d: model.init_io_params(seed=3,
                                                              device=d))
        sp_gpu = [copy.deepcopy(sp).to("cuda") for sp in sp_cpu]
        io_gpu = copy.deepcopy(io_cpu).to("cuda")
        batch, aux = small_inputs(cfg, s)
        with torch.no_grad():
            want = model.reference_forward(sp_cpu, io_cpu, batch, aux)
            got = model.reference_forward(
                sp_gpu, io_gpu, {k: v.cuda() for k, v in batch.items()},
                {k: v.cuda() for k, v in aux.items()})
        torch.cuda.synchronize()
        if got.shape != (1, s, cfg.padded_vocab()):
            raise AssertionError(f"logits of shape {tuple(got.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite logits on the card")
        check_close(f"{arch} widths, {layers} layers {cfg.pattern} "
                    f"(shared slots {model.shared_flags.tolist()}), {s} "
                    f"tokens: logits", got.cpu(), want, 1e-3)
        del sp_cpu, io_cpu, sp_gpu, io_gpu, got, want
        torch.cuda.empty_cache()


#: the small multimodal check: qwen2-vl-2b at full width, float32, one
#: layer per stage, 1 encoder stage + text + 2 LM stages
SMALL_MM = dict(enc_stages=1, lm_stages=2, enc_layers_per_stage=1,
                lm_layers_per_stage=1, text_seq=256, mean_enc_tokens=96,
                buckets=(64, 128, 192), reduced=False)
#: relative tolerance of the small multimodal check's loss, and of each
#: gradient's max |card - CPU| against its own max |.| (float32 sums in
#: another order, through the kernels' float32 paths)
TOL_MM = 1e-3


def phase_small_multimodal():
    """One forward and one backward of the multimodal DAG on the card
    (kernels) against the CPU (plain versions) on identical weights:
    qwen2-vl-2b at full width in float32, 1 encoder stage, the text stage
    and 2 LM stages of one layer each, 2 microbatches of 256 text tokens,
    through the actor runtime in fixed order with deterministic reduction.
    The losses and every parameter gradient must agree within TOL_MM."""
    import copy
    import dataclasses

    import torch

    from repro_torch.core import HintKind
    from repro_torch.data.synthetic import multimodal_batch
    from repro_torch.launch import train
    from repro_torch.multimodal import (
        MultimodalStageFns,
        MultimodalStageProgram,
        multimodal_config,
    )
    from repro_torch.multimodal.model import MultimodalModel
    from repro_torch.multimodal.stagefn import MultimodalStageOptions
    from repro_torch.runtime.rrfp import ActorConfig, ActorDriver

    print("small multimodal DAG step, card (kernels) vs CPU (plain), "
          "float32:")
    cfg = multimodal_config("qwen2-vl-2b", **SMALL_MM)
    cfg = dataclasses.replace(cfg, lm_cfg=dataclasses.replace(
        cfg.lm_cfg, dtype=torch.float32))
    model = MultimodalModel(cfg)
    m = 2
    fns = MultimodalStageFns(model, MultimodalStageOptions(
        mb_rows=1, loss_scale=1.0 / (m * cfg.text_seq)))
    params_cpu = drawn_on_card(lambda d: model.init_stage_params(seed=3,
                                                                device=d))
    arrays = multimodal_batch(cfg, m, 1, seed=5, step=0)
    out = {}
    for dev in ("cpu", "cuda"):
        params = (params_cpu if dev == "cpu" else
                  [copy.deepcopy(p).to("cuda") for p in params_cpu])
        batch = train._device_mm_batch(arrays, dev)
        programs = [MultimodalStageProgram(fns, s, params[s], batch,
                                           deterministic_reduction=True)
                    for s in range(cfg.num_stages)]
        acfg = ActorConfig(mode="precommitted", hint=HintKind.BF,
                           fixed_order="1f1b", deadlock_timeout=300.0)
        ActorDriver(cfg.spec(m), None, acfg).run_threaded(list(programs))
        for p in programs:
            p.finalize()
        out[dev] = ([p.loss_sum for p in programs],
                    [[None if g is None else g.cpu() for g in p.d_params]
                     for p in programs])
    l_cpu, l_gpu = sum(out["cpu"][0]), sum(out["cuda"][0])
    if not math.isfinite(l_gpu) or abs(l_gpu - l_cpu) > TOL_MM * abs(l_cpu):
        raise AssertionError(f"multimodal loss: card {l_gpu} vs CPU {l_cpu}")
    print(f"  loss sum: card {l_gpu:.6f}  CPU {l_cpu:.6f}  (tolerance "
          f"{TOL_MM:g} relative)  ok")
    worst = 0.0
    for s, (gc, gg) in enumerate(zip(out["cpu"][1], out["cuda"][1])):
        names = [n for n, _ in params_cpu[s].named_parameters()]
        for name, a, b in zip(names, gc, gg):
            if (a is None) != (b is None):
                raise AssertionError(f"stage {s} {name}: a gradient on one "
                                     f"device only")
            if a is None:
                continue
            rel = float((a - b).abs().max()) / max(float(a.abs().max()),
                                                   1e-30)
            worst = max(worst, rel)
            if not math.isfinite(rel) or rel > TOL_MM:
                raise AssertionError(f"stage {s} {name}: max |card - CPU| "
                                     f"is {rel:.3e} of max |grad|")
    print(f"  every gradient of {cfg.num_stages} stages: max |card - CPU| "
          f"at most {worst:.3e} of its max |.|  (tolerance {TOL_MM:g})  ok")


def decode_pass(model, sp, io, caches, tokens, pos):
    """One more greedy-decode pass outside the serve step: every batch row
    through every stage's ``stage_decode`` (caches updated in place).
    Returns the last stage's hidden state [B, 1, d] and the float32 logits
    [B, padded vocab]."""
    import torch

    from repro_torch.models.build import tree_map

    with torch.inference_mode():
        hs = []
        for row in range(tokens.shape[0]):
            x = io.embed[tokens[row:row + 1]][:, None]
            for s in range(model.num_stages):
                c = tree_map(lambda t: t[:, row:row + 1], caches[s])
                x, _ = model.stage_decode(sp[s], io, x, c, pos, {},
                                          model.rows(s))
            hs.append(x)
        h = torch.cat(hs)
        return h, model.head_logits(io, h)[:, 0].float()


def serve_launches(model, batch: int) -> dict[str, int]:
    """K2 and K3 launches of one serve step, counted from the layers: per
    batch row (one-row micro-groups), 2 norms per attention, Mamba, MoE,
    dense-FFN, mLSTM or sLSTM layer and shared-block application, 3 and one
    K3 per ``dec`` layer, none for ``enc``, plus the head's norm."""
    norms = {"attn": 2, "attn_local": 2, "attn_global": 2, "mamba": 2,
             "moe": 2, "dense": 2, "mlstm": 2, "slstm": 2, "dec": 3,
             "enc": 0}
    kinds = [model.layer_types[t] for t in model.type_ids.ravel() if t >= 0]
    shared = int(model.shared_flags.sum()) if model.cfg.shared_attn_period \
        else 0
    return {"rmsnorm": batch * (sum(norms[k] for k in kinds) + 2 * shared
                                + 1),
            "flash_decode": batch * kinds.count("dec")}


def phase_small_serve():
    """Greedy serving on the card (kernels) against the CPU (plain
    versions) on identical weights and caches: seamless at full widths with
    2 encoder + 2 decoder layers, float32, batch 2, the encoder's keys and
    values seeded (enc_len 1024), 4 tokens; then one more pass whose last
    hidden state must agree."""
    import copy
    import dataclasses

    import torch

    from repro_torch.models.build import build
    from repro_torch.pipeline.decode import DecodeOptions, make_staircase_fn

    print("small-input serve, card (kernels) vs CPU (plain), float32:")
    cfg = dataclasses.replace(small_config("seamless-m4t-large-v2", 4),
                              encoder_layers=2)
    model = build(cfg, num_stages=2)
    sp_cpu = [drawn_on_card(lambda d, s=s: model.init_stage_params(
        s, seed=3, device=d)) for s in range(2)]
    io_cpu = drawn_on_card(lambda d: model.init_io_params(seed=3, device=d))
    caches_cpu = [model.init_stage_cache(2, 64, 1024, device="cpu")
                  for _ in range(2)]
    g = torch.Generator().manual_seed(11)
    for c in caches_cpu:
        for name in ("xk", "xv"):
            c[name].copy_(torch.randn(c[name].shape, generator=g))
    step = make_staircase_fn(model, DecodeOptions(mb_rows=1, cache_len=64,
                                                  enc_len=1024), num_groups=2)
    first = torch.tensor([17, 250_000])
    out = {}
    for dev, sp, io, caches in (
            ("cpu", sp_cpu, io_cpu, caches_cpu),
            ("cuda", [copy.deepcopy(p).to("cuda") for p in sp_cpu],
             copy.deepcopy(io_cpu).to("cuda"),
             [{k: t.to("cuda") for k, t in c.items()} for c in caches_cpu])):
        toks, seq = first.to(dev), [first.tolist()]
        for pos in range(4):
            toks = step(sp, io, caches, {"tokens": toks}, pos)
            seq.append(toks.tolist())
        h, logits = decode_pass(model, sp, io, caches, toks, 4)
        out[dev] = (seq, h.cpu(), logits.cpu())
    if out["cuda"][0] != out["cpu"][0]:
        raise AssertionError(f"greedy tokens differ: card {out['cuda'][0]} "
                             f"vs CPU {out['cpu'][0]}")
    print(f"  tokens equal on the card and the CPU: {out['cuda'][0]}")
    if not torch.isfinite(out["cuda"][2]).all():
        raise AssertionError("non-finite logits on the card")
    check_close("seamless widths, 2 + 2 layers, 5th pass: last hidden state",
                out["cuda"][1], out["cpu"][1], 1e-3)


def main_path_work(argv, cfg=None) -> tuple[int, float]:
    """Tokens and model FLOPs of one step of a main path, from the port's
    ``ArchModel.model_flops`` of the run's config (``cfg``, else the arch's
    full one): 6 x active matmul weights incl. the head x tokens, plus
    causal attention per attention layer and shared-block application;
    recompute not counted."""
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models.build import build
    from repro_torch.models.common import ShapeCell

    args = train.parser().parse_args(argv)
    model = build(cfg or registry.get_arch(args.arch),
                  num_stages=args.stages)
    cell = ShapeCell("main", args.seq, args.microbatches * args.mb_rows,
                     "train")
    work = model.model_flops(cell)
    return work["tokens"], work["model_flops"]


def phase_main_path():
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    runs = {}
    for arch, path_runs, needed, layers in MAIN_PATHS:
        base = ["--arch", arch] + COMMON_ARGS
        cfg = None if layers is None else registry.cut_depth(arch, layers)
        for name, extra in path_runs:
            print(f"main path {arch} ({name}): python -m "
                  f"repro_torch.launch.train " + " ".join(base + extra)
                  + ("" if cfg is None else
                     f"  [cfg: registry.cut_depth({arch!r}, {layers}), "
                     f"{cfg.pattern}]"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            run = train.train_actor(train.parser().parse_args(base + extra),
                                    cfg=cfg)
            counts = ops.launch_counts()
            steps = len(run.losses)
            print(f"  {time.perf_counter() - t0:.1f} s wall  "
                  f"losses {run.losses}  step seconds {run.step_seconds}  "
                  f"launches {counts} "
                  f"({ {k: v / steps for k, v in counts.items()} } per step)"
                  f"  peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            print("  card after the run (SM clock, max SM clock, power, "
                  "temperature): " + card("clocks.sm,clocks.max.sm,"
                                          "power.draw,temperature.gpu"))
            if not all(math.isfinite(x) for x in run.losses):
                raise AssertionError(f"non-finite losses in the {arch} "
                                     f"{name} run")
            missing = [k for k in needed if counts[k] == 0]
            if missing:
                raise AssertionError(f"the {arch} {name} run launched no "
                                     f"{missing}")
            runs[arch, name] = (run, counts,
                                torch.cuda.max_memory_allocated())
            tokens, flops = main_path_work(base + extra, cfg)
            for i, sec in enumerate(run.step_seconds):
                print(f"  step {i}: {sec:.3f} s  {tokens / sec:,.0f} tokens/s"
                      f"  model FLOP utilization "
                      f"{flops / sec / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s "
                      f"({flops:.4g} FLOP/step)")
        torch.cuda.empty_cache()
        if (arch, "bfw") not in runs:
            continue
        l_bf = runs[arch, "bf"][0].losses[0]
        l_bfw = runs[arch, "bfw"][0].losses[0]
        if abs(l_bf - l_bfw) > TOL["bfloat16"] * max(1.0, abs(l_bf)):
            raise AssertionError(f"{arch} step-0 losses disagree: bf {l_bf} "
                                 f"vs bfw {l_bfw}")
        print(f"  {arch} step-0 loss bf {l_bf} vs bfw {l_bfw}: agree within "
              f"{TOL['bfloat16']:g} (relative)")
    return runs


#: the table runtime's runs (phase_table_path): paper-gpt3-large at full
#: width, 4 stages, 1 x 2048-token microbatches; (a) a 1 x 4 mesh of 8
#: microbatches, the actor runs' exact batch of 16,384 tokens, under each
#: schedule, 1f1b for 2 steps (``phase_procs_path`` runs it again), the
#: others for 1; (b) a 2 x 4 mesh (ZeRO-1 over two data ranks) of 4
#: microbatches per data rank, the same 16,384 tokens, 1 step
TABLE_ARGS = ["--runtime", "table", "--arch", "paper-gpt3-large",
              "--full-size", "--stages", "4", "--mb-rows", "1", "--seq",
              "2048", "--device", "cuda"]
TABLE_RUNS = [("table 1f1b", ["--devices", "4", "--microbatches", "8",
                              "--schedule", "1f1b", "--steps", "2"]),
              ("table gpipe", ["--devices", "4", "--microbatches", "8",
                               "--schedule", "gpipe", "--steps", "1"]),
              ("table zb", ["--devices", "4", "--microbatches", "8",
                            "--schedule", "zb", "--steps", "1"]),
              ("table rrfp", ["--devices", "4", "--microbatches", "8",
                              "--schedule", "rrfp", "--steps", "1"]),
              ("table 1f1b 2x4", ["--devices", "8", "--microbatches", "4",
                                  "--schedule", "1f1b", "--steps", "1"])]
#: relative tolerance of a table run's step-0 loss against the actor bf
#: run's (same weights, same batch; the sums over microbatches and ranks
#: run in another order)
TOL_TABLE_LOSS = 1e-4
#: relative tolerance of a table run's step-0 gradient norm (before
#: clipping) against the actor bf run's (its bf16 gradients summed over
#: microbatches, data ranks and stages in another order: about bf16's
#: rounding; the readings are in PERF.md)
TOL_TABLE_GNORM = 1e-2


def check_step0(label, run, actor) -> None:
    """A table run's step-0 loss and gradient norm against the actor bf
    run's on the same weights and batch: the forward, and the backward
    through every gradient the optimizer sees."""
    l0, la = run.losses[0], actor.losses[0]
    g0, ga = run.gnorms[0], actor.gnorms[0]
    rel_l = abs(l0 - la) / abs(la)
    rel_g = abs(g0 - ga) / abs(ga)
    print(f"  step-0 loss {l0} vs actor bf {la}: {rel_l:.3e} relative "
          f"(tolerance {TOL_TABLE_LOSS:g}); gnorm {g0} vs actor bf {ga}: "
          f"{rel_g:.3e} relative (tolerance {TOL_TABLE_GNORM:g})")
    if not rel_l <= TOL_TABLE_LOSS:
        raise AssertionError(f"{label} step-0 loss {l0} vs actor bf {la}")
    if not rel_g <= TOL_TABLE_GNORM:
        raise AssertionError(f"{label} step-0 gnorm {g0} vs actor bf {ga}")


def table_launches(model, table, data: int) -> dict[str, int]:
    """K1 and K2 launches of one table step, counted from the layers and
    the table: a stage forward launches one K1 per attention layer,
    ``enc`` layer and shared-block application, two per ``dec`` layer
    (self- and cross-attention), and the norms of ``serve_launches`` (2 per
    attention or ``enc`` layer, 3 per ``dec``); F runs the layers once, B
    and W twice (the remat
    forward, then the slot checkpoint's recompute in the backward), a
    split B not at all at stage 0 (its input gradient has no receiver);
    the last stage's final norm (outside the slot checkpoints) runs once
    in each of its ops; every data rank runs the whole table."""
    from repro_torch.pipeline.spec import OP_B, OP_F, OP_W

    attn = {"attn": 1, "attn_local": 1, "attn_global": 1, "moe": 1,
            "dense": 1, "enc": 1, "dec": 2}
    norms = {"attn": 2, "attn_local": 2, "attn_global": 2, "mamba": 2,
             "moe": 2, "dense": 2, "mlstm": 2, "slstm": 2, "enc": 2,
             "dec": 3}
    split = table.spec.split_backward
    k1 = k2 = 0
    for s in range(model.num_stages):
        kinds = [model.layer_types[t] for t in model.type_ids[s] if t >= 0]
        shared = (int(model.shared_flags[s].sum())
                  if model.cfg.shared_attn_period else 0)
        f1 = sum(attn.get(k, 0) for k in kinds) + shared
        f2 = sum(norms[k] for k in kinds) + 2 * shared
        ops = table.ops[s]
        n_f = int((ops == OP_F).sum())
        n_b = int((ops == OP_B).sum()) * (not split or s > 0)
        n_w = int((ops == OP_W).sum()) * split
        passes = n_f + 2 * n_b + 2 * n_w
        k1 += passes * f1
        k2 += passes * f2 + (n_f + n_b + n_w) * (s == model.num_stages - 1)
    return {"flash_attention_fwd": data * k1, "rmsnorm": data * k2}


#: the small table steps (arch, layers, data, stages, seq, enc_len):
#: gpt3 cut to 4 layers on 1 x 4; seamless cut to 2 encoder + 2 decoder
#: layers on 1 x 2 with 192 encoder frames against 128 tokens (the
#: cross-attention's sq != sk); deepseek-moe cut to its dense layer and
#: one MoE layer on 2 x 2 (``ep``: 32 of the 64 experts a data rank; the
#: data axis's reduce-scatter is held here).  Their CPU halves, float32
#: at full width on the host, set the phase's time
SMALL_TABLES = [("paper-gpt3-large", 4, 1, 4, 128, 0),
                ("seamless-m4t-large-v2", 4, 1, 2, 128, 192),
                ("deepseek-moe-16b", 2, 2, 2, 128, 0)]


def phase_small_table():
    """One table step (executor only) per SMALL_TABLES entry, at full
    width cut to its layers (``registry.cut_depth``), float32, 1
    microbatch per data rank, on the card (kernels) against the CPU (plain
    versions) on identical weights (made on the CPU, seed 3): the loss,
    every all-gathered grad shard and every routed expert's grad (the
    data ranks' shards concatenated) within TOL_MM of its own max.  Then
    the MoE ``tp`` layout at the level of the layer (``moe_tp_layer``)."""
    for case in SMALL_TABLES:
        small_table_step(*case)
    moe_tp_layer()


def small_table_step(arch, layers, data, stages, seq, enc_len):
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import synth_batch
    from repro_torch.launch import train
    from repro_torch.models.convert import zero1_state_to_reference
    from repro_torch.pipeline.executor import shard_batch

    cfg = dataclasses.replace(registry.cut_depth(arch, layers),
                              dtype=torch.float32)
    print(f"small table step {arch} {cfg.pattern} ({data} x {stages} mesh, "
          f"seq {seq}" + (f", {enc_len} encoder frames" if enc_len else "")
          + "), card (kernels) vs CPU (plain), float32:")
    f32 = {"io_grad_dtype": torch.float32, "flat_dtype": torch.float32}
    if enc_len:
        f32["enc_len"] = enc_len
    init = {}

    def init_params(model, mesh, device):
        if not init:
            init["sp"] = [drawn_on_card(
                lambda d, s=s: model.init_stage_params(s, seed=3, device=d))
                for s in range(model.num_stages)]
            init["io"] = drawn_on_card(
                lambda d: model.init_io_params(seed=3, device=d))
        data, stage_params = mesh.shape["data"], []
        for r in range(mesh.size):
            c = mesh.coords(r)
            sp = init["sp"][c["model"]]
            sp = (model.shard_stage_params(sp, data, c["data"])
                  if model.moe_layout != "none" and data > 1
                  else copy.deepcopy(sp))
            stage_params.append(sp.to(device))
        return (stage_params, [copy.deepcopy(init["io"]).to(device)
                               for _ in range(mesh.size)])

    out = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        t = train.build_trainer(
            arch, data=data, stages=stages, layers=None, mb_rows=1,
            microbatches=1, seq=seq, schedule="1f1b", device=dev, cfg=cfg,
            init_params=init_params, exec_options=f32)
        mesh = t["mesh"]
        batch = train._device_batch(synth_batch(cfg, data, seq, seed=5,
                                                step=0, enc_len=enc_len),
                                    dev)
        shards = shard_batch(mesh, batch, t["batch_specs"])
        res = mesh.run(t["exec_fn"], [
            (t["stage_params"][r], t["io_params"][r], shards[r])
            for r in range(mesh.size)])
        ref = zero1_state_to_reference(
            t["model"], mesh, t["partition"],
            [{"shards": {k: {"g": g} for k, g in o[1].items()},
              "experts": {k: {"g": g} for k, g in o[2].items()}}
             for o in res])
        grads = {**ref["shards"], **{"expert " + k: v for k, v
                                     in ref["experts"].items()}}
        out[dev] = (float(res[0][0]["loss"]), grads)
        print(f"  {dev}: loss {out[dev][0]:.6f}  "
              f"{time.perf_counter() - t0:.1f} s  collectives "
              f"{dict(sorted(mesh.counts.items()))}")
        del t, res
    l_cpu, l_gpu = out["cpu"][0], out["cuda"][0]
    if not math.isfinite(l_gpu) or abs(l_gpu - l_cpu) > TOL_MM * abs(l_cpu):
        raise AssertionError(f"table loss: card {l_gpu} vs CPU {l_cpu}")
    worst = 0.0
    for k, g in out["cpu"][1].items():
        a, b = g["g"], out["cuda"][1][k]["g"]
        rel = float(abs(a - b).max()) / max(float(abs(a).max()), 1e-30)
        worst = max(worst, rel)
        if not math.isfinite(rel) or rel > TOL_MM:
            raise AssertionError(f"table grad shard {k}: max |card - CPU| "
                                 f"is {rel:.3e} of max |grad|")
    n_exp = sum(k.startswith("expert ") for k in out["cpu"][1])
    print(f"  loss within {TOL_MM:g} relative; {len(out['cpu'][1]) - n_exp}"
          f" grad shards and {n_exp} expert grads: max |card - CPU| at most "
          f"{worst:.3e} of their max |.| (tolerance {TOL_MM:g})  ok")
    torch.cuda.empty_cache()


def moe_tp_layer():
    """The MoE ``tp`` layout at the level of the layer: ``moe_ffn`` of the
    reduced deepseek-moe config (8 experts, so ``tp``: each rank holds
    every expert's d_ff / 2 slice), float32, over a 2-rank mesh, forward
    and the phased backward (``models/phases.py``: the exchanges and their
    transposes called by the rank threads while the card's autograd runs
    on its own thread), held against the same on the CPU mesh and against
    ``layout="none"`` per rank with the whole weights, within TOL_MM of
    each tensor's max; a second launch on the card gives the same bits.
    No attention kernel runs here."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.phases import phased_grads

    cfg = registry.reduced_config("deepseek-moe-16b", 4)
    data, layout = 2, "tp"
    rng = np.random.default_rng(7)
    whole = moe.MoEFFN(cfg, None, "cpu")
    with torch.no_grad():
        for p in whole.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                     .astype(np.float32) * 0.3))
    xs = [torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model))
                           .astype(np.float32)) for _ in range(data)]
    gys = [torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model))
                            .astype(np.float32)) for _ in range(data)]
    names = [n for n, _ in whole.named_parameters()]

    def shard(i, device):
        part = moe.MoEFFN(cfg, None, device, layout=layout, data_size=data)
        with torch.no_grad():
            for (n, p), q in zip(part.named_parameters(), whole.parameters()):
                dim = moe.expert_shard_dim(n, layout)
                p.copy_(q if dim is None else moe.take_shard(q, dim, data, i))
        return part

    def on_mesh(device):
        mesh = make_mesh(data, 1, device=device)
        ex = mesh.exchange_over("data")
        parts = [shard(i, device) for i in range(data)]

        def rank(r):
            p = parts[r]
            phases, cuts = moe.moe_phases(p, cfg, layout, data)
            gx, grads, out = phased_grads(
                phases, cuts, {"h": xs[r].to(device)}, ex,
                list(p.parameters()), {"h": gys[r].to(device)}, ("h",))
            return [out["h"].detach(), gx["h"], *grads]

        res = mesh.run(rank, [(r,) for r in range(data)])
        return [[t.cpu() for t in per_rank] for per_rank in res], mesh

    card_a, mesh = on_mesh("cuda")
    card_b, _ = on_mesh("cuda")
    cpu, _ = on_mesh("cpu")
    whole_runs = []
    for r in range(data):
        x = xs[r].clone().requires_grad_()
        y = moe.moe_ffn(whole, x, cfg)
        whole_runs.append([y.detach(), *torch.autograd.grad(
            y, [x] + list(whole.parameters()), gys[r])])
    print(f"MoE tp layer (reduced deepseek-moe, {cfg.moe.num_experts} "
          f"experts, d_ff {cfg.d_ff} split over {data} ranks), forward + "
          f"phased backward on the card vs the CPU mesh vs layout none; "
          f"collectives {dict(sorted(mesh.counts.items()))}:")
    worst = 0.0
    for r in range(data):
        for j, what in enumerate(["y", "dx"] + names):
            a, b, c = card_a[r][j], card_b[r][j], cpu[r][j]
            if not torch.equal(a, b):
                raise AssertionError(f"tp layer rank {r} {what}: two "
                                     f"launches differ")
            want = whole_runs[r][j]
            dim = None if j < 2 else moe.expert_shard_dim(what, layout)
            if dim is not None:  # every rank's tokens, this rank's shard
                want = moe.take_shard(sum(w[j] for w in whole_runs), dim,
                                      data, r)
            for other, label in ((c, "CPU mesh"), (want, "layout none")):
                scale = max(float(other.abs().max()), 1e-30)
                rel = float((a - other).abs().max()) / scale
                worst = max(worst, rel)
                if not math.isfinite(rel) or rel > TOL_MM:
                    raise AssertionError(f"tp layer rank {r} {what}: card vs "
                                         f"{label} {rel:.3e} of its max")
    print(f"  y, dx and {len(names)} parameter grads on both ranks: max "
          f"|card - CPU mesh|, |card - layout none| at most {worst:.3e} of "
          f"their max (tolerance {TOL_MM:g}); two launches bitwise  ok")


def table_run(label, name, argv, cfg=None, step_hook=None):
    """One ``--runtime table`` run, ``train.main(argv)`` (with ``cfg`` or
    ``step_hook``, ``train_table(args, cfg=cfg, step_hook=step_hook)``, as
    the launcher runs it), its launch
    counts zeroed just before and read just after: finite losses and
    gnorms, and K1 and K2 launched exactly as ``table_launches`` counts.
    Prints the mesh's collectives per step (every rank's calls).  Returns
    (run, counts, peak bytes); ``run.trainer`` is kept for the caller's own
    checks."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    print(f"main path {label} ({name}): python -m repro_torch.launch.train "
          + " ".join(argv) + ("" if cfg is None else
                              f"  [cfg: registry.cut_depth, {cfg.pattern}]"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if cfg is None and step_hook is None:
        run = train.main(argv)
    else:
        args = train.parser().parse_args(argv)
        train._check_table_flags(args)
        run = train.train_table(args, cfg=cfg, step_hook=step_hook)
    counts = ops.launch_counts()
    mem = torch.cuda.max_memory_allocated()
    t = run.trainer
    steps = len(run.losses)
    want = {k: steps * v for k, v in table_launches(
        t["model"], t["table"], t["mesh"].shape["data"]).items()}
    tokens = t["batch_size"] * t["seq"]
    print(f"  {time.perf_counter() - t0:.1f} s wall  losses {run.losses}  "
          f"gnorms {run.gnorms}  step seconds "
          f"{run.step_seconds}  launches {counts} (from the code "
          f"{want})  peak memory {mem / 2**30:.2f} GiB")
    for i, coll in enumerate(run.collectives):
        print(f"  step {i} collectives (calls, host seconds inside them, "
              f"summed over the {t['mesh'].size} ranks): "
              + ", ".join(f"{k} {n} {sec:.3f}"
                          for k, (n, sec) in coll.items()))
    for i, sec in enumerate(run.step_seconds):
        print(f"  step {i}: {sec:.3f} s  {tokens / sec:,.0f} tokens/s")
    print("  card after the run (SM clock, max SM clock, power, "
          "temperature): " + card("clocks.sm,clocks.max.sm,"
                                  "power.draw,temperature.gpu"))
    if not all(math.isfinite(x) for x in run.losses + run.gnorms):
        raise AssertionError(f"the {label} {name} run gave losses "
                             f"{run.losses}, gnorms {run.gnorms}")
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"the {label} {name} run launched {counts}, "
                             f"the code counts {want}")
    return run, counts, mem


def same_runs(label, a, b) -> None:
    """Two runs of one command: the same loss and gnorm bits over the
    steps both ran."""
    n = min(len(a.losses), len(b.losses))
    if (a.losses[:n], a.gnorms[:n]) != (b.losses[:n], b.gnorms[:n]):
        raise AssertionError(f"two {label} runs differ: {a.losses} "
                             f"{a.gnorms} vs {b.losses} {b.gnorms}")
    print(f"  two {label} runs: the same bits over {n} steps "
          f"(losses {b.losses[:n]}, gnorms {b.gnorms[:n]})")


def phase_table_path(actor_runs):
    """The table runtime's main path through ``repro_torch.launch.train
    --runtime table`` (TABLE_ARGS + TABLE_RUNS): paper-gpt3-large at full
    width through K1 and K2, four schedules on a 1 x 4 mesh and 1f1b on a
    2 x 4 mesh, each checked by ``table_run``; each run's step-0 loss must
    be the actor bf run's (``actor_runs``: same weights, same batch) within
    TOL_TABLE_LOSS and its gradient norm within TOL_TABLE_GNORM
    (``check_step0``); after the 2 x 4 run the two data replicas'
    parameters must be bitwise equal.  The 1f1b runs keep their ranks'
    parameter digests for ``phase_procs_path``, which runs 1f1b again."""
    import torch

    runs = {}
    actor = actor_runs["paper-gpt3-large", "bf"][0]
    for name, extra in TABLE_RUNS:
        run, counts, mem = table_run("paper-gpt3-large", name,
                                     TABLE_ARGS + extra)
        t = run.trainer
        check_step0(name, run, actor)
        if name == "table 1f1b 2x4":
            check_replicas(t, len(run.losses))
        keep_digests(run)
        run.trainer = None
        del t
        runs["paper-gpt3-large", name] = (run, counts, mem)
        torch.cuda.empty_cache()
    return runs


def keep_digests(run) -> None:
    """A thread run's every rank's replicated stage leaves as digests
    (``procs.leaf_digests``) in ``run.ranks``, as a ``--procs`` run reports
    them."""
    from repro_torch.launch.procs import leaf_digests

    t = run.trainer
    run.ranks = [{"rank": r, "digests": leaf_digests(t["partition"], sp)}
                 for r, sp in enumerate(t["stage_params"])]


def check_replicas(t, steps: int) -> None:
    """After a table run on more than one data rank, every rank holds its
    data-index-0 twin's replicated stage leaves bitwise; a data-sharded
    leaf (the MoE layouts' experts) is a shard, no replica, and is left
    out."""
    import torch

    mesh, part = t["mesh"], t["partition"]
    shards = [k for k in part.stage_keys if part.stage_data_sharded[k]]
    for r in range(mesh.size):
        twin = mesh.rank_of(data=0, model=mesh.coords(r)["model"])
        mine = part.stage_leaves(t["stage_params"][r].parameters())
        theirs = part.stage_leaves(t["stage_params"][twin].parameters())
        for k in part.stage_keys:
            if part.stage_data_sharded[k]:
                continue
            if not all(torch.equal(a, b) for a, b in zip(mine[k],
                                                         theirs[k])):
                raise AssertionError(f"rank {r} and its replica {twin} "
                                     f"hold other {k}")
    print(f"  the data replicas' replicated parameters are bitwise equal "
          f"after {steps} steps"
          + (f" (the data-sharded expert leaves {shards} left out)"
             if shards else ""))


#: the MoE table path (phase_moe_table_path): deepseek-moe-16b at full
#: width cut to 4 layers (the dense layer, then 3 MoE layers of 64
#: experts, top-6, 2 shared) through ``--runtime table`` on a 2 x 2 mesh
#: (2 stages of 2 layers): the ``ep`` layout, 32 experts a data rank, 4
#: microbatches of 1 x 2048 tokens per data rank (the actor bf run's 8
#: rows); 1f1b twice and zb once, 2 steps each.  A 2 x 4 mesh (eight
#: ranks, each with its own io copy and every slot the union of the dense
#: and MoE leaves: 69.2 GiB of weights, grads and optimizer state) ran out
#: of memory in step 0, in the last stage's first B, with 76.83 GiB
#: allocated of the card's 79.18 (``launch/profile.py``, PERF.md)
MOE_TABLE_LAYERS = 4
MOE_TABLE_ARGS = ["--runtime", "table", "--arch", "deepseek-moe-16b",
                  "--full-size", "--devices", "4", "--stages", "2",
                  "--microbatches", "4", "--mb-rows", "1", "--seq", "2048",
                  "--steps", "2", "--device", "cuda"]
MOE_TABLE_RUNS = [("table 1f1b", ["--schedule", "1f1b"]),
                  ("table zb", ["--schedule", "zb"])]


def phase_moe_table_path():
    """deepseek-moe-16b through ``--runtime table`` (MOE_TABLE_ARGS, the
    config ``registry.cut_depth``): the MoE exchanges over the data ranks,
    called by the rank threads between autograd calls, with K1 and K2;
    each run checked by ``table_run``; its step-0 loss and gradient norm
    within TOL_TABLE_LOSS and TOL_TABLE_GNORM of a deepseek actor bf
    step's on the table's stages (``check_step0``; same weights: the
    seeded init draws each layer from its stage and slot; same batch);
    after each run the data replicas hold bitwise equal replicated
    leaves."""
    import gc

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import train

    gc.collect()  # the earlier table runs' ranks and state
    torch.cuda.empty_cache()
    arch = "deepseek-moe-16b"
    cfg = registry.cut_depth(arch, MOE_TABLE_LAYERS)
    argv = ["--arch", arch] + COMMON_ARGS + ["--steps", "1", "--hint", "bf"]
    i = argv.index("--stages") + 1
    argv[i] = MOE_TABLE_ARGS[MOE_TABLE_ARGS.index("--stages") + 1]
    print("the actor bf reference of the MoE table runs: python -m "
          "repro_torch.launch.train " + " ".join(argv))
    actor = train.train_actor(train.parser().parse_args(argv), cfg=cfg)
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    for name, extra in MOE_TABLE_RUNS:
        run, counts, mem = table_run(arch, name, MOE_TABLE_ARGS + extra,
                                     cfg=cfg)
        t = run.trainer
        if t["model"].moe_layout != "ep":
            raise AssertionError(f"{arch}: layout {t['model'].moe_layout}")
        check_step0(f"{arch} {name}", run, actor)
        check_replicas(t, len(run.losses))
        keep_digests(run)
        run.trainer = None
        del t
        runs[arch, name] = (run, counts, mem)
        gc.collect()
        torch.cuda.empty_cache()
    return runs


#: the table runtime with one process per rank (phase_procs_path): the
#: 1f1b runs of TABLE_RUNS (1 x 4 and 2 x 4) again with ``--procs`` (gloo:
#: payloads staged through host memory); the 1 x 4 run takes 3 steps and
#: saves a table checkpoint at step 2 (``procs_checkpoint``)
PROCS_RUNS = [("table 1f1b", ["--devices", "4", "--microbatches", "8",
                              "--schedule", "1f1b", "--steps", "2"]),
              ("table 1f1b 2x4", ["--devices", "8", "--microbatches", "4",
                                  "--schedule", "1f1b", "--steps", "1"])]
#: (c)'s depth, on both sides of the comparison: four processes of the
#: MOE_TABLE_LAYERS model peak at 16.6-17.2 GiB each (67.5 GiB together),
#: and with five CUDA contexts and each allocator's reserve they filled
#: the 80 GB card (80,968 MiB used in one run, out of memory in rank 1's
#: first B in another); 2 layers, the dense one and one MoE layer, one a
#: stage, keep the ``ep`` exchanges of the MoE stage
MOE_PROCS_LAYERS = 2
#: free disk (b)'s ``--procs`` checkpoint needs: one step directory of
#: gpt3's table checkpoint on 4 stages, 679,550,976 stage and 154,535,424
#: io parameters as float32, and ZeRO-1's master, m and v of the stage
#: leaves and of each stage's io copy: 4 x (834,086,400 + 3 x (679,550,976
#: + 4 x 154,535,424)) = 18.9 GB
PROCS_CKPT_FREE_BYTES = 21e9
#: the mesh's collectives in a world of four processes on CUDA tensors
PROCS_COLLECTIVES = [("collectives float32", "collectives", (0, "float32")),
                     ("collectives bfloat16", "collectives",
                      (1, "bfloat16"))]


def phase_procs_path(runs):
    """The table runtime on a mesh of processes (``launch/procs.py``, one
    process per rank, gloo), against the thread mesh's runs of the same
    call: (a) every collective on CUDA tensors in a 2 x 2 world, bitwise
    the thread mesh's (``launch/mesh_probes.collectives``); (b) gpt3 1f1b
    with ``--procs`` on 1 x 4 for 3 steps, saving a table checkpoint at
    step 2 (every rank's state gathered through rank 0's host), the thread
    run once more for 3 steps (in turns: its step time, the first run's
    bits, the process run's bits) whose step-2 checkpoint tree every leaf
    of the file must equal, and ``--procs --resume`` from the file, whose
    step 2 must be both runs' bits (``procs_checkpoint``), then 2 x 4:
    losses,
    gnorms and every rank's replicated parameters (digests) bitwise the
    thread runs', K1/K2 launches summed over the processes as
    ``table_launches`` counts; (c) deepseek-moe ``ep`` cut to
    MOE_PROCS_LAYERS on 2 x 2, a thread run and then ``--procs``, bitwise; (d) ``--dist-backend nccl`` with 4
    ranks on one card stops before a world starts.  Each process's peak
    memory, the card's ``memory.used`` during the run and both meshes'
    step times are printed."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import mesh_probes, train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.procs import spawn_world

    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    t0 = time.perf_counter()
    shape = {"data": 2, "model": 2}
    got = mesh_probes.merge(spawn_world(
        mesh_probes.several, (PROCS_COLLECTIVES,), 4, shape=shape,
        device="cuda", backend="gloo", deadline=300.0))
    want = mesh_probes.several(Mesh(shape, device="cuda"), PROCS_COLLECTIVES)
    for r in range(4):
        for label, _, _ in PROCS_COLLECTIVES:
            mesh_probes.check_same_bits(got[r][label], want[r][label],
                                        f"{label}, rank {r}")
    print(f"(a) every collective over every axis tuple, float32 and "
          f"bfloat16 CUDA tensors, 4 processes (gloo, staged) on 2 x 2: "
          f"bitwise the thread mesh's ({time.perf_counter() - t0:.1f} s "
          f"with the spawn)")

    arch = "paper-gpt3-large"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_procs_"))
    try:
        for name, extra in PROCS_RUNS:
            thread = runs[arch, name][0]
            if name != "table 1f1b":
                run, counts, mem = procs_run(arch, name, TABLE_ARGS + extra)
                same_procs_bits(f"{arch} {name}", run, thread)
                out[arch, name + " procs"] = (run, counts, mem)
                continue
            free = shutil.disk_usage(tmp).free
            if free < PROCS_CKPT_FREE_BYTES:
                raise AssertionError(f"{tmp}: {free / 1e9:.1f} GB free, the "
                                     f"--procs checkpoint needs "
                                     f"{PROCS_CKPT_FREE_BYTES / 1e9:.0f}")
            out.update(procs_checkpoint(arch, name, TABLE_ARGS + extra,
                                        tmp / "ckpt", thread))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("table 1f1b", "table 1f1b again", "table 1f1b 2x4"):
        r = (out.get((arch, name)) or runs[arch, name])[0]
        p = out.get((arch, name + " procs"), (None,))[0]
        print(f"  {arch} {name}: step s threads {r.step_seconds}"
              + ("" if p is None else f", processes {p.step_seconds}"))

    moe = "deepseek-moe-16b"
    cfg = registry.cut_depth(moe, MOE_PROCS_LAYERS)
    name = f"table 1f1b {MOE_PROCS_LAYERS} layers"
    argv = with_flag(MOE_TABLE_ARGS + ["--schedule", "1f1b"], "--steps", "1")
    thread, c2, m2 = table_run(moe, name, argv, cfg=cfg)
    t = thread.trainer
    if t["model"].moe_layout != "ep":
        raise AssertionError(f"{moe}: layout {t['model'].moe_layout}")
    check_replicas(t, len(thread.losses))
    keep_digests(thread)
    thread.trainer = None
    del t
    out[moe, name] = (thread, c2, m2)
    gc.collect()
    torch.cuda.empty_cache()
    run, counts, mem = procs_run(moe, name, argv, cfg=cfg)
    same_procs_bits(f"{moe} {name}", run, thread)
    print(f"  {moe} {name}: step s threads {thread.step_seconds}, "
          f"processes {run.step_seconds}")
    out[moe, name + " procs"] = (run, counts, mem)

    argv = (TABLE_ARGS + PROCS_RUNS[0][1]
            + ["--procs", "--dist-backend", "nccl"])
    try:
        train.main(argv)
    except SystemExit as e:
        if "4 ranks on 1 card(s)" not in str(e):
            raise AssertionError(f"--dist-backend nccl stopped with {e}")
        print(f"(d) --dist-backend nccl, 4 ranks: SystemExit ({e})")
    else:
        raise AssertionError("--dist-backend nccl with 4 ranks on one card "
                             "did not stop")
    return out


@contextlib.contextmanager
def memory_used(every: float = 0.5):
    """The card's ``memory.used`` (MiB) sampled every ``every`` s on a
    thread while the block runs, into the list it yields."""
    import threading

    used: list[int] = []
    stop = threading.Event()

    def sample():
        while not stop.wait(every):
            used.append(int(card("memory.used").split()[0]))

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        yield used
    finally:
        stop.set()
        sampler.join()


def before_spawn() -> None:
    """Print what this process holds before it spawns a world."""
    import torch

    print(f"  this process before the spawn: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, host "
          f"RSS {host_rss() / 2**30:.2f} GiB; card memory.used "
          f"{card('memory.used')}")


def procs_run(arch, name, argv, cfg=None):
    """``train_table`` with ``--procs`` (``cfg`` as ``table_run``'s): the
    processes' K1/K2 launches summed (each child counts from 0) must be
    ``table_launches``'s; finite losses and gnorms; the 2-or-more data
    replicas' digests equal.  Prints each process's peak memory, the
    card's largest ``memory.used`` while the world ran (sampled every 0.5
    s) and the collectives a step.  Returns (run, summed launches, the
    largest process peak)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core.taskgraph import PipelineSpec
    from repro_torch.launch import train
    from repro_torch.models.build import build
    from repro_torch.pipeline import schedules

    argv = argv + ["--procs"]
    print(f"main path {name} --procs ({arch}): python -m "
          f"repro_torch.launch.train " + " ".join(argv)
          + ("" if cfg is None else
             f"  [cfg: registry.cut_depth, {cfg.pattern}]"))
    args = train.parser().parse_args(argv)
    train._check_procs_flags(args)
    train._check_table_flags(args)
    torch.cuda.empty_cache()
    before_spawn()
    t0 = time.perf_counter()
    with memory_used() as used:
        run = train.train_table(args, cfg=cfg)
    wall = time.perf_counter() - t0
    cfg = cfg or registry.get_arch(args.arch)
    model = build(cfg, num_stages=args.stages)
    table = schedules.BUILDERS[args.schedule](PipelineSpec(
        args.stages, args.microbatches,
        split_backward=args.schedule == "zb"))
    data = args.devices // args.stages
    steps = len(run.losses)
    warm = warm_launches(model, data)
    want = {k: steps * v + warm[k] for k, v in table_launches(
        model, table, data).items()}
    counts = {k: sum(r["launches"][k] for r in run.ranks)
              for k in run.ranks[0]["launches"]}
    peaks = [r["peak_bytes"] for r in run.ranks]
    print(f"  losses {run.losses}  gnorms {run.gnorms}  step seconds "
          f"{run.step_seconds}  launches summed over {len(run.ranks)} "
          f"processes {counts} (from the code {want}: {steps} steps and the "
          f"warm-up's {warm})  {wall:.1f} s with the spawn")
    print("  peak memory a process (GiB, device / host RSS): "
          + ", ".join(f"rank {r['rank']} {r['peak_bytes'] / 2**30:.2f} / "
                      f"{r['peak_rss_bytes'] / 2**30:.2f}"
                      for r in run.ranks)
          + f"; sum {sum(peaks) / 2**30:.2f}; card memory.used at most "
          f"{max(used, default=0)} MiB")
    for i, coll in enumerate(run.collectives):
        print(f"  step {i} collectives (calls, host seconds inside them, "
              f"summed over the {len(run.ranks)} processes): "
              + ", ".join(f"{k} {n} {sec:.3f}"
                          for k, (n, sec) in coll.items()))
    if not all(math.isfinite(x) for x in run.losses + run.gnorms):
        raise AssertionError(f"{arch} {name} --procs gave losses "
                             f"{run.losses}, gnorms {run.gnorms}")
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{arch} {name} --procs launched {counts}, "
                             f"the code counts {want}")
    for r in run.ranks:
        twin = run.ranks[r["coords"]["model"]]  # its data-index-0 replica
        if r["digests"] != twin["digests"]:
            raise AssertionError(f"{arch} {name} --procs: rank {r['rank']} "
                                 f"and its replica {twin['rank']} differ")
    if data > 1:
        print(f"  the {data} data replicas' replicated parameters: the same "
              f"digests in every process")
    return run, counts, max(peaks)


def procs_checkpoint(arch, name, argv, ckpt, thread) -> dict:
    """(b)'s 1 x 4 run with a table checkpoint: ``argv`` with ``--procs
    --steps 3 --ckpt-every 2`` saves ``ckpt/step_2``, gathered through
    rank 0's host and written while step 2 runs.  The thread mesh runs
    ``argv`` again, in turns, for 3 steps (its first 2 the first thread
    run's bits, ``thread``; all 3 the process run's, every rank's
    parameters included) and keeps, at step 2, each leaf's digest of its
    ``train._table_ckpt_tree`` on the host (writing nothing); every leaf of
    the file must have its digest.  Then ``--procs --steps 3 --resume``
    runs step 2 only, and its loss and gnorm must be both runs' step 2,
    bitwise.  Prints the bytes, the gather (moves and conversion), write
    and restore seconds, each process's peak host RSS and device peak and
    the card's largest ``memory.used``, by the card's name and power
    limit."""
    import gc

    from repro_torch.launch import train

    smi = card()
    argv = with_flag(argv, "--steps", "3")
    saver, counts, mem = procs_run(arch, name, argv + [
        "--ckpt-dir", str(ckpt), "--ckpt-every", "2"])
    (save,) = [e for e in saver.ckpt_log if e["op"] == "save"]
    if save["step"] != 2:
        raise AssertionError(f"{arch} {name} --procs saved {save}")
    print(f"  --procs checkpoint of step 2 ({smi}): {save['bytes']:,} "
          f"bytes, gathered to rank 0's host in "
          f"{save['gather_seconds']:.3f} s (moves {save['move_seconds']:.3f} "
          f"s), written in {save['write_seconds']:.3f} s while step 2 ran; "
          f"rank 0's host RSS at most {save['peak_rss_bytes'] / 2**30:.2f} "
          f"GiB after the gather")
    gc.collect()
    kept: dict = {}

    def keep(step, t):
        if step == 1:  # after step 2: what --ckpt-every 2 saved
            t0 = time.perf_counter()
            kept.update(tree_digests(train._table_ckpt_tree(t)))
            print(f"  the thread run's step-2 checkpoint tree: {len(kept)} "
                  f"leaves built and hashed on the host in "
                  f"{time.perf_counter() - t0:.1f} s")

    again, c2, m2 = table_run(arch, name + " again", argv, step_hook=keep)
    keep_digests(again)
    again.trainer = None
    same_runs(f"{arch} {name}", thread, again)
    same_procs_bits(f"{arch} {name}", saver, again)
    t0 = time.perf_counter()
    got = npz_digests(ckpt / "step_2" / "shard_0.npz")
    differ = sorted(k for k in set(got) | set(kept)
                    if got.get(k) != kept.get(k))
    if differ:
        raise AssertionError(f"{ckpt}/step_2: {len(differ)} leaves differ "
                             f"from the thread run's, e.g. {differ[:3]}")
    print(f"  {ckpt}/step_2/shard_0.npz: every one of its {len(got)} leaves "
          f"the thread run's bits (sha256 of dtype, shape and bytes; read "
          f"and hashed in {time.perf_counter() - t0:.1f} s)")
    gc.collect()  # the thread run's ranks, before four processes start
    resumed, c3, m3 = procs_run(arch, name + " resume", argv + [
        "--ckpt-dir", str(ckpt), "--resume"])
    (restore,) = [e for e in resumed.ckpt_log if e["op"] == "resume"]
    for label, whole in (("thread", again), ("--procs", saver)):
        if (resumed.losses, resumed.gnorms) != (whole.losses[2:],
                                                whole.gnorms[2:]):
            raise AssertionError(f"--procs --resume: {resumed.losses} "
                                 f"{resumed.gnorms}, the {label} run's step "
                                 f"2 {whole.losses[2:]} {whole.gnorms[2:]}")
    print(f"  --procs --resume ({smi}): step 2 only, loss {resumed.losses} "
          f"gnorm {resumed.gnorms}, bitwise the thread and --procs runs' "
          f"step 2; rank 0 read step 2 in {restore['read_seconds']:.3f} s "
          f"and restored every rank in {restore['seconds']:.3f} s")
    return {(arch, name + " procs"): (saver, counts, mem),
            (arch, name + " again"): (again, c2, m2),
            (arch, name + " resume procs"): (resumed, c3, m3)}


def with_flag(argv, flag, value) -> list:
    """``argv`` with ``flag``'s value replaced."""
    argv = list(argv)
    argv[argv.index(flag) + 1] = value
    return argv


def leaf_digest(a) -> str:
    """sha256 of an array's dtype, shape and bytes."""
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str} {a.shape}".encode())
    h.update(a.reshape(-1).view(np.uint8).data)
    return h.hexdigest()


def tree_digests(tree) -> dict[str, str]:
    """Each leaf's digest of a checkpoint tree, as the store would write
    it (``ckpt/store._flatten``: bf16 widened), hashed on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.ckpt.store import _flatten

    arrays = _flatten(tree)
    with ThreadPoolExecutor(8) as pool:
        return dict(zip(arrays, pool.map(leaf_digest, arrays.values())))


def npz_digests(path) -> dict[str, str]:
    """Each member's digest of an ``.npz`` (``ckpt/store.read_member``:
    the zip's CRC-32 checked), one member in memory per thread (8
    threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.ckpt.store import npz_members, read_member

    infos = npz_members(str(path))
    with ThreadPoolExecutor(8) as pool:
        return dict(zip((i.filename.removesuffix(".npy") for i in infos),
                        pool.map(lambda i: leaf_digest(
                            read_member(str(path), i)), infos)))


def host_rss() -> int:
    """This process's resident host memory now (``VmRSS``), in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS")


def warm_launches(model, data: int) -> dict[str, int]:
    """K1 and K2 launches of ``--procs``'s warm-up (``train._warm_up``):
    each rank one F and one fused B of its stage, counted as
    ``table_launches`` counts a table of those two ops."""
    from repro_torch.pipeline.spec import OP_B, OP_F

    return table_launches(
        model, fused_table([[OP_F, OP_B]] * model.num_stages), data)


def fused_table(ops_by_stage):
    """A stand-in table of fused ops, ``ops_by_stage`` (``table_launches``
    reads its ``spec.split_backward`` and ``ops``)."""
    import types

    import numpy as np

    return types.SimpleNamespace(
        spec=types.SimpleNamespace(split_backward=False),
        ops=np.array(ops_by_stage))


def same_procs_bits(label, procs, thread) -> None:
    """A ``--procs`` run and the thread run of the same command: the same
    loss and gnorm bits, every rank's replicated parameters the same
    digests (so the data replicas agree too)."""
    if (procs.losses, procs.gnorms) != (thread.losses, thread.gnorms):
        raise AssertionError(f"{label}: processes {procs.losses} "
                             f"{procs.gnorms}, threads {thread.losses} "
                             f"{thread.gnorms}")
    for p, t in zip(procs.ranks, thread.ranks, strict=True):
        if p["digests"] != t["digests"]:
            raise AssertionError(f"{label}: rank {p['rank']}'s parameters "
                                 f"differ from the thread run's")
    print(f"  {label}: processes and threads give the same bits over "
          f"{len(procs.losses)} steps (losses, gnorms, every rank's "
          f"replicated parameters)")


#: the enc-dec table path (phase_enc_dec_table_path):
#: seamless-m4t-large-v2 at full width and depth (24 + 24 layers), 4
#: stages on a 1 x 4 mesh, 8 microbatches of 1 x 2048 decoder tokens and
#: 2048 encoder frames (16,384 decoder tokens a step), bf16, 1f1b, twice,
#: 1 step each.
#: Every rank holds its own io copy (2 x 262e6 parameters) with its whole
#: ZeRO-1 state at dp 1, and the four ranks' AdamW update of those leaves
#: sets the peak: it fits one 80 GB card with ``optim/adamw.py``'s
#: operation-by-operation update (PERF.md section 4)
ENC_DEC_TABLE_ARGS = ["--runtime", "table", "--arch",
                      "seamless-m4t-large-v2", "--full-size", "--devices",
                      "4", "--stages", "4", "--microbatches", "8",
                      "--mb-rows", "1", "--seq", "2048", "--schedule",
                      "1f1b", "--steps", "1", "--device", "cuda"]
ENC_DEC_TABLE_RUNS = ("table 1f1b", "table 1f1b again")


def phase_enc_dec_table_path():
    """seamless-m4t-large-v2 through ``--runtime table`` at full width and
    depth (ENC_DEC_TABLE_ARGS): K1 causal in the decoder's self-attention
    and non-causal in the encoder and the cross-attention (sq 2048 tokens
    against sk 2048 frames), K2; each run checked by ``table_run``, and the
    two runs give the same bits."""
    import gc

    import torch

    gc.collect()  # the earlier table runs' ranks and state
    torch.cuda.empty_cache()
    arch = "seamless-m4t-large-v2"
    runs = {}
    for name in ENC_DEC_TABLE_RUNS:
        run, counts, mem = table_run(arch, name, ENC_DEC_TABLE_ARGS)
        run.trainer = None
        runs[arch, name] = (run, counts, mem)
        torch.cuda.empty_cache()
    same_runs(f"{arch} table 1f1b", *(runs[arch, n][0]
                                      for n in ENC_DEC_TABLE_RUNS))
    return runs


#: the cells through ``launch/cells.build_cell`` (phase_cells_path):
#: paper-gpt3-large x train_4k planned on a 1 x 4 mesh, its global batch of
#: 256 rows cut to CELL_ROWS one-row microbatches of CELL_SEQ tokens
CELL_ARCH = "paper-gpt3-large"
CELL_SEQ = 4096
CELL_ROWS = 8
CELL_STEPS = 1
#: the op bodies timed against their roofline time: a mid stage's
CELL_MID_STAGE = 1
CELL_OP_REPS = 3
#: the re-layout forward: one [1, RELAYOUT_SEQ] batch through the 4- and
#: the 2-stage chain; float32 tolerance should the bf16 chains differ (the
#: reference's tests/test_fault_tolerance.py)
RELAYOUT_SEQ = 2048
TOL_RELAYOUT_F32 = 2e-4


def phase_cells_path():
    """The cell matrix on the card (ROADMAP 18d): the gpt3 ``train_4k``
    cell through ``build_cell`` (``cell_train_gpt3``, with the roofline's
    op times against the card's) and the full-width stage re-layout
    (``cell_relayout_gpt3``).  The gemma3-4b ``long_500k`` cell runs inside
    ``serve_mesh_gemma``, beside the serve mesh's own ``sp_mode`` run."""
    import gc

    import torch

    gc.collect()  # the earlier table runs' ranks and state
    torch.cuda.empty_cache()
    runs = cell_train_gpt3()
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(cell_relayout_gpt3())
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def cell_train_gpt3():
    """paper-gpt3-large x train_4k at full width and depth through
    ``launch/cells.build_cell``: planned by ``plan_cell`` on the 1 x 4 mesh
    of ``build_trainer(seq=CELL_SEQ, microbatches=CELL_ROWS, schedule="1f1b",
    reduced=False)``, its 256 rows cut to CELL_ROWS with
    ``dataclasses.replace``, CELL_STEPS steps of the cell's step function
    and the trainer's ZeRO-1 AdamW on the trainer's seeded weights.  Step
    0's loss and every rank's grad shards must equal, bit for bit, those of
    the trainer's own executor on the same weights and batch (one executor
    wired by two callers); each step's K1 and K2 launches exactly
    ``table_launches``; finite losses.  Then the roofline
    (``analysis/roofline.py``) against the card: F and B of a mid stage
    (CELL_MID_STAGE, 6 layers, one row of CELL_SEQ tokens) timed with CUDA
    events after a warm-up (stream time, launch gaps included), each beside
    ``_t(per_op_costs(plan)[op])`` at the H100 constants; no op may run
    faster than its roofline time (a count too high would show so).
    Returns the run for ``main``'s record."""
    import dataclasses

    import torch

    from repro_torch.analysis import roofline
    from repro_torch.data.synthetic import synth_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import cells
    from repro_torch.launch.train import TrainRun, _device_batch, build_trainer
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.pipeline.executor import shard_batch
    from repro_torch.pipeline.stagefn import StageFnOptions, StageFns

    smi = card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = build_trainer(CELL_ARCH, data=1, stages=4, layers=None, mb_rows=1,
                      microbatches=CELL_ROWS, seq=CELL_SEQ, schedule="1f1b",
                      reduced=False, device="cuda")
    mesh = t["mesh"]
    plan = cells.plan_cell(CELL_ARCH, "train_4k", mesh, num_stages=4)
    print(f"cell {CELL_ARCH} x train_4k through launch.cells.build_cell on "
          f"{mesh}: planned {plan.num_microbatches} microbatches of "
          f"{plan.mb_rows} x {plan.seq_len}, cut to {CELL_ROWS} (global "
          f"batch {plan.cell.global_batch} -> {CELL_ROWS})")
    plan = dataclasses.replace(
        plan, num_microbatches=CELL_ROWS,
        cell=dataclasses.replace(plan.cell, global_batch=CELL_ROWS))
    fn, _, specs = cells.build_cell(plan, mesh, schedule="1f1b")
    table = cells.schedule_table(plan, "1f1b")
    want = table_launches(plan.model, table, 1)
    _, opt_update = make_optimizer(t["model"], mesh, t["partition"],
                                   t["opt_cfg"])
    run = TrainRun(losses=[], step_seconds=[])
    launches: dict = {}
    for step in range(CELL_STEPS):
        arrays = synth_batch(t["cfg"], CELL_ROWS, CELL_SEQ, seed=0,
                             step=step)
        shards = shard_batch(mesh, _device_batch(arrays, "cuda"), specs)
        args = [(t["stage_params"][r], t["io_params"][r], shards[r])
                for r in range(mesh.size)]
        ref = mesh.run(t["exec_fn"], args) if step == 0 else None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = mesh.run(fn, args)
        counts = ops.launch_counts()
        stats = mesh.run(opt_update, [
            (t["stage_params"][r], t["io_params"][r], t["opt_state"][r],
             out[r][1], out[r][2], step) for r in range(mesh.size)])
        loss = float(out[0][0]["loss"])
        run.step_seconds.append(time.perf_counter() - t0)
        run.losses.append(loss)
        run.gnorms.append(float(stats[0]["gnorm"]))
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"cell step {step} launched {counts}, the "
                                 f"code counts {want}")
        if ref is not None:
            for r, ((m, gs, eg), (rm, rgs, reg)) in enumerate(zip(out, ref)):
                if not torch.equal(m["loss"], rm["loss"]) or sorted(gs) != \
                        sorted(rgs) or eg or reg or not all(
                            torch.equal(gs[k], rgs[k]) for k in gs):
                    raise AssertionError(f"cell step 0 rank {r}: loss or "
                                         f"grad shards differ from "
                                         f"build_trainer's executor")
            print(f"  step 0: loss {loss} and the grad shards of all "
                  f"{mesh.size} ranks ({sum(len(o[1]) for o in out)} "
                  f"leaves) bit for bit build_trainer's executor's")
            del ref
    mem = torch.cuda.max_memory_allocated()
    tokens = CELL_ROWS * CELL_SEQ
    print(f"  losses {run.losses}  gnorms {run.gnorms}  step seconds "
          f"{run.step_seconds}  launches {launches} (from the code "
          f"{CELL_STEPS} x {want})  peak memory {mem / 2**30:.2f} GiB  "
          f"[{smi}]")
    for i, sec in enumerate(run.step_seconds):
        print(f"  step {i}: {sec:.3f} s  {tokens / sec:,.0f} tokens/s")
    if not all(math.isfinite(x) for x in run.losses + run.gnorms):
        raise AssertionError(f"cell losses {run.losses}, gnorms {run.gnorms}")

    # the roofline's op times against the card's
    oc = roofline.per_op_costs(plan)
    fns = StageFns(plan.model, StageFnOptions(mb_rows=1, seq_len=CELL_SEQ))
    s = CELL_MID_STAGE
    sp, io = t["stage_params"][s], t["io_params"][s]
    bm = {k: v[:1] for k, v in shards[s].items()}
    g = torch.Generator(device="cuda").manual_seed(11)
    d, dt = plan.model.cfg.d_model, plan.model.cfg.dtype
    x = torch.randn((1, CELL_SEQ, d), generator=g, device="cuda").to(dt)
    g_in = torch.randn((1, CELL_SEQ, d), generator=g,
                       device="cuda").to(dt) * 1e-3
    bodies = {"F": lambda: fns.forward(s)(sp, io, x, bm),
              "B": lambda: fns.backward(s)(sp, io, x, g_in, bm)}
    for op, body in bodies.items():
        body()  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CELL_OP_REPS):
            body()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / CELL_OP_REPS
        roof_ms = roofline._t(oc[op]) * 1e3
        print(f"  roofline {op} (stage {s}, {plan.model.counts[s]} layers, "
              f"1 x {CELL_SEQ}): {oc[op]['flops']:.4g} FLOP, "
              f"{oc[op]['bytes']:.4g} B counted -> {roof_ms:.3f} ms at 989 "
              f"TFLOP/s and 3.35 TB/s; measured {ms:.3f} ms (CUDA events "
              f"over {CELL_OP_REPS} calls, stream time with launch gaps), "
              f"{ms / roof_ms:.2f}x  [{smi}]")
        if not ms >= roof_ms:
            raise AssertionError(f"roofline {op}: measured {ms:.3f} ms is "
                                 f"below its bound {roof_ms:.3f} ms")
    prod = roofline.roofline_cell(CELL_ARCH, "train_4k")
    print(f"  roofline_cell({CELL_ARCH}, train_4k) on the 16 x 16 "
          f"production mesh, H100 constants: est_step_s "
          f"{prod.est_step_s:.4f}, projected_mfu {prod.projected_mfu:.4f}, "
          f"compute {prod.compute_s:.4f} s, memory {prod.memory_s:.4f} s, "
          f"collective {prod.collective_s:.4f} s ({prod.dominant})")
    return {(CELL_ARCH, "cell train_4k"): (run, launches, mem)}


def cell_relayout_gpt3():
    """Stage re-layout (``runtime/elastic.relayout_stage_params``) at full
    width: paper-gpt3-large's seeded 4-stage parameters, exported with
    ``convert.params_to_reference``, shrunk to 2 stages and regrown to 4:
    every live slot must come back bit for bit.  Then the 4-stage and the
    2-stage chains run one seeded [1, RELAYOUT_SEQ] batch in bf16 through
    K1 and K2 (each launched as the 24 layers count): the same layers in
    the same order at the same shapes, so the last hidden states must be
    bitwise equal; were they not, the difference is printed and both
    chains are held in float32 at TOL_RELAYOUT_F32."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.ckpt.store import _leaves_with_path
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainRun
    from repro_torch.models.build import build
    from repro_torch.models.common import global_layer_index
    from repro_torch.models.convert import (params_from_reference,
                                            params_to_reference)
    from repro_torch.runtime.elastic import relayout_stage_params

    cfg = registry.get_arch(CELL_ARCH)
    m4 = build(cfg, 4)
    sp4 = [m4.init_stage_params(s, seed=0, device="cuda") for s in range(4)]
    io = m4.init_io_params(seed=0, device="cuda")
    t0 = time.perf_counter()
    sp_np, io_np = params_to_reference(m4, sp4, io)
    m2, sp2_np = relayout_stage_params(m4, 2, sp_np)
    m4b, sp4b_np = relayout_stage_params(m2, 4, sp2_np)
    live = global_layer_index(m4.counts) >= 0
    a, b = list(_leaves_with_path(sp_np)), list(_leaves_with_path(sp4b_np))
    if [k for k, _ in a] != [k for k, _ in b] or not all(
            x.dtype == y.dtype and np.array_equal(x[live], y[live])
            for (_, x), (_, y) in zip(a, b)):
        raise AssertionError("re-layout 4 -> 2 -> 4 changed a live slot")
    print(f"re-layout {CELL_ARCH} (full width, {cfg.num_layers} layers): "
          f"4 -> 2 -> 4 stages, {len(a)} leaves, every live slot bit for "
          f"bit ({time.perf_counter() - t0:.1f} s on the host)")
    def as_model(tree):  # the export holds bf16 leaves as float32
        if isinstance(tree, dict):
            return {k: as_model(v) for k, v in tree.items()}
        return torch.from_numpy(tree).to(cfg.dtype)

    sp2, io2 = params_from_reference(m2, as_model(sp2_np), as_model(io_np),
                                     "cuda")
    g = torch.Generator().manual_seed(13)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, RELAYOUT_SEQ),
                                     generator=g).to("cuda")}

    def chain(model, sp, io):
        aux = {"positions": torch.arange(RELAYOUT_SEQ, dtype=torch.int32,
                                         device="cuda")[None],
               "data_size": 1, "moe_layout": "none"}
        with torch.no_grad():
            x = model.embed(io, batch)
            for s in range(model.num_stages):
                x = model.stage_forward(sp[s], io, x, aux, model.rows(s))
        return x

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    y4 = chain(m4, sp4, io)
    y2 = chain(m2, sp2, io2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {"flash_attention_fwd": 2 * cfg.num_layers,
            "rmsnorm": 2 * 2 * cfg.num_layers}
    print(f"  4-stage and 2-stage chains, bf16, [1, {RELAYOUT_SEQ}]: "
          f"{secs:.3f} s, launches {counts} (from the code {want})")
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"re-layout chains launched {counts}, the code "
                             f"counts {want}")
    if not torch.isfinite(y4.float()).all():
        raise AssertionError("re-layout: the 4-stage chain is not finite")
    if torch.equal(y4, y2):
        print("  the last hidden states are bit for bit equal")
    else:
        err = float((y4.float() - y2.float()).abs().max())
        print(f"  the bf16 last hidden states differ by {err:.3e}: held in "
              f"float32 at {TOL_RELAYOUT_F32:g}")
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        k4, k2 = build(f32, 4), build(f32, 2)
        z4 = chain(k4, *params_from_reference(k4, sp_np, io_np, "cuda"))
        z2 = chain(k2, *params_from_reference(k2, sp2_np, io_np, "cuda"))
        e32 = float((z4 - z2).abs().max())
        print(f"  float32: max |4-stage - 2-stage| {e32:.3e}")
        if not e32 <= TOL_RELAYOUT_F32:
            raise AssertionError(f"re-layout float32 chains differ by "
                                 f"{e32:.3e}")
    run = TrainRun(losses=[], step_seconds=[secs])
    return {(CELL_ARCH, "relayout forward"): (run, counts, 0)}


#: the runs of phase_runtime_flags: paper-gpt3-large at full width,
#: COMMON_ARGS, cut to RUNTIME_FLAGS_LAYERS layers (``registry.cut_depth``,
#: 1 a stage): the flags' semantics do not depend on the depth, and the
#: full depth's 10 GB checkpoint and its two restores took 89 s of the
#: phase's 185 (PERF.md section 4)
GPT3_ARGS = ["--arch", "paper-gpt3-large"] + COMMON_ARGS
RUNTIME_FLAGS_LAYERS = 4
FIXED_ORDER = ["--schedule", "1f1b"]
#: --hb-deadline of the recovery runs.  Their faults are kills, which
#: announce themselves: the deadline only arms the stall watchdog (no stage
#: stalls here) and sets the recovery coordinator's poll, hb/4, which a
#: step under --recover may wait out once at its end
HB_DEADLINE = "2.0"
#: free disk the checkpoint runs need: one step directory of 267,793,920
#: parameters (113,258,496 in the 4 layers, 154,535,424 io) x 4 bytes x 3
#: trees (params as float32, m, v) = 3.2 GB
CKPT_FREE_BYTES = 4.5e9


def phase_runtime_flags():
    """The runtime flags of ``repro_torch.launch.train`` on paper-gpt3-large
    (full width, GPT3_ARGS, RUNTIME_FLAGS_LAYERS layers through
    ``train_actor(args, cfg=...)``), each held against its unfailed or
    uninterrupted
    run; K1 and K2 must launch in every run (counts zeroed just before and
    read just after each).

    * obs: ``--steps 3 --metrics-report --explain --export-perfetto``; the
      export passes ``validate_chrome_trace`` and the recorded step-0 trace
      ``check_all``.
    * two identical unfailed ``1f1b`` runs (``--steps 2``) and, in turns
      with them, two with ``--metrics-report``: the step times with and
      without telemetry, and the identical-run spread that every equality
      below is held to (0: bitwise).
    * checkpoint: ``--steps 3 --ckpt-every 2`` saves once, at step 2 (3.2
      GB, in a temporary directory removed at the end); ``--resume`` runs step 2
      from it and must give the writer's step-2 loss.
    * recovery: a ``kill`` of stage 1 under ``--recover`` (respawned from
      the live step-start params) against the unfailed run, and a kill of
      stage 2 under ``--resume --recover`` (respawned through
      ``restore_host`` of the checkpoint) against the writer's step 2; the
      recovery windows come from the recorded traces, which pass
      ``check_all``.
    * adaptive: ``--steps 3 --adaptive --resynth-every 1`` (rrfp, hint bf)
      within TOL["bfloat16"] of the obs run (the same flags without
      ``--adaptive``), ``check_all`` (table faithfulness included) on its
      step-0 trace; the scheduler's decisions and swaps are printed.
    """
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.core.taskgraph import PipelineSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.runtime.rrfp import ActorConfig
    from repro_torch.runtime.rrfp.conformance import check_all

    runs = {}
    spec = PipelineSpec(4, 8)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    cfg = registry.cut_depth("paper-gpt3-large", RUNTIME_FLAGS_LAYERS)

    def launch(name, extra):
        argv = GPT3_ARGS + extra
        print(f"runtime flags ({name}): python -m repro_torch.launch.train "
              + " ".join(argv) + f"  [cfg: registry.cut_depth, {cfg.pattern}]")
        args = train.parser().parse_args(argv)
        train._check_procs_flags(args)
        train._check_flags(args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        run = train.train_actor(args, cfg=cfg)
        counts = ops.launch_counts()
        mem = torch.cuda.max_memory_allocated()
        print(f"  {time.perf_counter() - t0:.1f} s wall  losses {run.losses}"
              f"  step seconds {run.step_seconds}  "
              f"launches {counts}  peak memory {mem / 2**30:.2f} GiB")
        if not run.losses or not all(math.isfinite(x) for x in run.losses):
            raise AssertionError(f"the {name} run gave losses {run.losses}")
        missing = [k for k in ("flash_attention_fwd", "rmsnorm")
                   if counts[k] == 0]
        if missing:
            raise AssertionError(f"the {name} run launched no {missing}")
        runs["paper-gpt3-large", name] = (run, counts, mem)
        torch.cuda.empty_cache()
        return run

    def outage(run, name):
        windows = run.trace.recovery_windows()
        if not windows:
            raise AssertionError(f"the {name} run recorded no recovery")
        for w in windows:
            print(f"  recovery of stage {w['stage']}: outage (fail to back "
                  f"in service) {w['t_end'] - w['t_fail']:.4f} s, detected "
                  f"after {w['t_detect'] - w['t_fail']:.4f} s, epoch "
                  f"{w['epoch_to']}, mode {w['mode']}")
        check_all(run.trace, spec, ActorConfig(mode="precommitted"))
        print(f"  check_all green on the {name} trace "
              f"({len(run.trace.events)} events)")

    try:
        # -- observability ------------------------------------------------
        perfetto = tmp / "step0.perfetto.json"
        obs = launch("obs", ["--steps", "3", "--metrics-report", "--explain",
                             "--export-perfetto", str(perfetto)])
        doc = json.loads(perfetto.read_text())
        validate_chrome_trace(doc)
        check_all(obs.trace, spec, ActorConfig(mode="hint"))
        print(f"  perfetto export valid ({len(doc['traceEvents'])} trace "
              f"events); check_all green on the recorded step-0 trace "
              f"({len(obs.trace.events)} events)")

        # -- identical unfailed runs; telemetry on and off in turns --------
        plain, metered = [], []
        for i in (1, 2):
            plain.append(launch(f"1f1b {i}", ["--steps", "2"] + FIXED_ORDER))
            metered.append(launch(f"1f1b metrics-report {i}",
                                  ["--steps", "2", "--metrics-report"]
                                  + FIXED_ORDER))
        spread = max(abs(a - b) for a, b in zip(plain[0].losses,
                                                 plain[1].losses))
        print(f"  two identical unfailed 1f1b runs: {plain[0].losses} vs "
              f"{plain[1].losses}: "
              + ("bitwise equal, so every gate below is bitwise"
                 if spread == 0 else
                 f"spread {spread!r}, the bound of every gate below"))

        def gate(what, got, want):
            d = max(abs(a - b) for a, b in zip(got, want, strict=True))
            if d > spread:
                raise AssertionError(f"{what}: {got} vs {want}, |diff| {d!r} "
                                     f"> identical-run spread {spread!r}")
            print(f"  {what}: {got} vs {want}: "
                  + ("bitwise equal" if d == 0 else
                     f"|diff| {d!r} <= identical-run spread {spread!r}"))

        for run in metered:
            gate("--metrics-report against the unfailed run", run.losses,
                 plain[0].losses)
        for k in range(2):
            off = [r.step_seconds[k] for r in plain]
            on = [r.step_seconds[k] for r in metered]
            print(f"  step {k} seconds without --metrics-report {off}, with "
                  f"{on}: overhead {sum(on) / 2 - sum(off) / 2:+.4f} s/step "
                  f"(mean of 2 each)")

        # -- checkpoint ----------------------------------------------------
        free = shutil.disk_usage(tmp).free
        if free < CKPT_FREE_BYTES:
            raise AssertionError(f"{tmp}: {free / 1e9:.1f} GB free, the "
                                 f"checkpoint runs need "
                                 f"{CKPT_FREE_BYTES / 1e9:.0f} GB")
        ckpt = str(tmp / "ckpt")
        writer = launch("checkpoint write",
                        ["--steps", "3", "--ckpt-dir", ckpt, "--ckpt-every",
                         "2"] + FIXED_ORDER)
        saves = [e for e in writer.ckpt_log if e["op"] == "save"]
        if [e["step"] for e in saves] != [2]:
            raise AssertionError(f"expected one save at step 2: {saves}")
        print(f"  saved step 2: {saves[0]['bytes']:,} bytes in "
              f"{saves[0]['seconds']:.3f} s "
              f"({saves[0]['bytes'] / saves[0]['seconds'] / 1e9:.2f} GB/s)")
        resumed = launch("resume", ["--steps", "3", "--ckpt-dir", ckpt,
                                    "--resume"] + FIXED_ORDER)
        (restore,) = [e for e in resumed.ckpt_log if e["op"] == "resume"]
        print(f"  resume restored step {restore['step']} in "
              f"{restore['seconds']:.3f} s")
        gate("resumed step 2 against the writer's", resumed.losses,
             writer.losses[2:])

        # -- recovery ------------------------------------------------------
        print(f"  --hb-deadline {HB_DEADLINE} s on the recovery runs")
        killed = launch("recover kill",
                        ["--steps", "2", "--chaos",
                         "fail_stage=1,fail_kind=kill,fail_after=5",
                         "--recover", "--hb-deadline", HB_DEADLINE,
                         "--record-trace", str(tmp / "kill.trace.jsonl")]
                        + FIXED_ORDER)
        gate("kill + --recover against the unfailed run", killed.losses,
             plain[0].losses)
        outage(killed, "kill")
        # --ckpt-every 2: no second save at step 3 (--recover's default
        # cadence is 1)
        rr = launch("resume + recover",
                    ["--steps", "3", "--resume", "--recover", "--chaos",
                     "fail_stage=2,fail_after=3", "--ckpt-dir", ckpt,
                     "--ckpt-every", "2", "--hb-deadline", HB_DEADLINE,
                     "--record-trace", str(tmp / "rr.trace.jsonl")]
                    + FIXED_ORDER)
        gate("resume + kill + --recover against the writer's step 2",
             rr.losses, writer.losses[2:])
        for e in rr.ckpt_log:
            print(f"  {e['op']} restore of step {e['step']}: "
                  f"{e['seconds']:.3f} s")
        if not any(e["op"] == "respawn" for e in rr.ckpt_log):
            raise AssertionError("the respawn did not restore from the "
                                 "checkpoint")
        outage(rr, "resume + recover")
        shutil.rmtree(ckpt)

        # -- adaptive hint loop --------------------------------------------
        ad = launch("adaptive", ["--steps", "3", "--adaptive",
                                 "--resynth-every", "1", "--hint", "bf",
                                 "--record-trace",
                                 str(tmp / "adaptive.trace.jsonl")])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, (a, b) in enumerate(zip(ad.losses, obs.losses, strict=True)):
        if abs(a - b) > TOL["bfloat16"] * max(1.0, abs(b)):
            raise AssertionError(f"adaptive step {k} loss {a} vs the plain "
                                 f"rrfp run's {b}")
    print(f"  adaptive losses {ad.losses} vs plain rrfp {obs.losses}: agree "
          f"within {TOL['bfloat16']:g} (relative)")
    if not any(ev.info.get("path") == "table" for ev in ad.trace.events
               if ev.kind == "dispatch"):
        raise AssertionError("the adaptive step-0 trace has no table-path "
                             "dispatch")
    check_all(ad.trace, spec, ActorConfig(mode="hint"))
    print("  check_all (table faithfulness included) green on the adaptive "
          "step-0 trace")
    sched = ad.scheduler
    for d in sched.decisions:
        print(f"  decision {json.dumps(d.to_json())}")
    print(f"  adaptive swaps: {len(sched.swaps)} at steps {sched.swaps} "
          f"(table v{sched.version})"
          + ("" if sched.swaps else ": no swap fired on these costs"))
    return runs


def phase_multimodal_path():
    """The multimodal main path through ``repro_torch.launch.train
    --workload multimodal`` (MM_ARGS): hint bf for 3 steps, then bfw for 2;
    then 2 bf steps of ``train_multimodal(args, model=...)`` with the
    reference's full-size encoder settings (MM_REAL_ENCODER: encoder
    microbatches of ~2048 tokens in buckets up to 4096).  The launch
    counts are zeroed just before each run and read just after; K1 and K2
    must launch in each, the losses be finite, and bf and bfw give the same
    step-0 loss."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.multimodal import multimodal_model

    runs = {}
    label = "qwen2-vl-2b multimodal"
    real = ("real encoder bf", ["--steps", "2", "--hint", "bf"])
    for name, extra in MM_RUNS + [real]:
        argv = MM_ARGS + extra
        model = None
        if name == real[0]:
            i = argv.index("--seq") + 1
            argv[i] = str(MM_REAL_ENCODER["text_seq"])
            enc, lm = train._multimodal_stage_split(4)
            model = multimodal_model("qwen2-vl-2b", enc_stages=enc,
                                     lm_stages=lm, reduced=False,
                                     **MM_REAL_ENCODER)
        print(f"main path {label} ({name}): python -m "
              f"repro_torch.launch.train " + " ".join(argv)
              + (f"  [model: multimodal_config(..., {MM_REAL_ENCODER})]"
                 if model is not None else ""))
        args = train.parser().parse_args(argv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        run = train.train_multimodal(args, model=model)
        counts = ops.launch_counts()
        mem = torch.cuda.max_memory_allocated()
        steps = len(run.losses)
        tokens = args.microbatches * args.mb_rows * args.seq
        print(f"  {time.perf_counter() - t0:.1f} s wall  losses {run.losses}"
              f"  step seconds {run.step_seconds}  "
              f"launches {counts} "
              f"({ {k: v / steps for k, v in counts.items()} } per step)"
              f"  peak memory {mem / 2**30:.2f} GiB")
        for i, sec in enumerate(run.step_seconds):
            print(f"  step {i}: {sec:.3f} s  {tokens / sec:,.0f} text "
                  f"tokens/s")
        print("  card after the run (SM clock, max SM clock, power, "
              "temperature): " + card("clocks.sm,clocks.max.sm,"
                                      "power.draw,temperature.gpu"))
        if not all(math.isfinite(x) for x in run.losses):
            raise AssertionError(f"non-finite losses in the multimodal "
                                 f"{name} run")
        missing = [k for k in ("flash_attention_fwd", "rmsnorm")
                   if counts[k] == 0]
        if missing:
            raise AssertionError(f"the multimodal {name} run launched no "
                                 f"{missing}")
        runs[label, name] = (run, counts, mem)
        del model
        torch.cuda.empty_cache()
    l_bf = runs[label, "bf"][0].losses[0]
    l_bfw = runs[label, "bfw"][0].losses[0]
    if abs(l_bf - l_bfw) > TOL["bfloat16"] * max(1.0, abs(l_bf)):
        raise AssertionError(f"multimodal step-0 losses disagree: bf {l_bf} "
                             f"vs bfw {l_bfw}")
    print(f"  {label} step-0 loss bf {l_bf} vs bfw {l_bfw}: agree within "
          f"{TOL['bfloat16']:g} (relative)")
    return runs


#: the last hidden state of each SERVE_PATHS run's extra decode pass, which
#: the serve runs on a mesh are held against
SERVE_HIDDEN: dict = {}


def phase_serve_path():
    """The serve runs of SERVE_PATHS through ``launch.serve``; each is
    checked for its exact launch counts, tokens inside the padded vocab,
    and finite logits from one more decode pass (outside the counts)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    runs = {}
    for arch, tokens, layers, stages in SERVE_PATHS:
        argv = ["--arch", arch, "--tokens", str(tokens)] + SERVE_ARGS
        argv[argv.index("--stages") + 1] = str(stages)
        cfg = None if layers is None else registry.cut_depth(arch, layers)
        print(f"main path {arch} (serve): python -m repro_torch.launch.serve "
              + " ".join(argv)
              + ("" if cfg is None else
                 f"  [cfg: registry.cut_depth({arch!r}, {layers})]"))
        args = serve.parser().parse_args(argv)
        t0 = time.perf_counter()
        server = serve.build_server(arch, stages=args.stages, layers=None,
                                    batch=args.batch,
                                    cache_len=args.cache_len, reduced=False,
                                    device="cuda", seed=args.seed, cfg=cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        run = serve.serve(args, server=server)
        counts = ops.launch_counts()
        mem = torch.cuda.max_memory_allocated()
        model, cfg = server["model"], server["cfg"]
        want = {k: v * tokens for k, v in
                serve_launches(model, args.batch).items()}
        steady = run.step_seconds[1:]
        print(f"  {time.perf_counter() - t0:.1f} s wall with the build  "
              f"step seconds {run.step_seconds}  launches {counts} "
              f"({ {k: v / tokens for k, v in counts.items()} } per step; "
              f"from the layers {want})  peak memory {mem / 2**30:.2f} GiB")
        print(f"  first step {run.step_seconds[0]:.3f} s, then "
              f"{sum(steady) / len(steady) * 1e3:.2f} ms/step, "
              f"{args.batch * len(steady) / sum(steady):.1f} tokens/s")
        print("  card after the run (SM clock, max SM clock, power, "
              "temperature): " + card("clocks.sm,clocks.max.sm,"
                                      "power.draw,temperature.gpu"))
        for name, n in want.items():
            if counts[name] != n:
                raise AssertionError(f"the {arch} serve run launched "
                                     f"{name} {counts[name]} times, its "
                                     f"layers give {n}")
        toks = torch.tensor(run.tokens)
        if toks.shape != (args.batch, tokens + 1) or not (
                (toks >= 0) & (toks < cfg.padded_vocab())).all():
            raise AssertionError(f"{arch} serve tokens of shape "
                                 f"{tuple(toks.shape)} or outside the vocab")
        h, logits = decode_pass(model, server["sp"], server["io"],
                                server["caches"], toks[:, -1].cuda(), tokens)
        SERVE_HIDDEN[arch] = h.cpu()
        if logits.shape != (args.batch, cfg.padded_vocab()) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: logits of shape "
                                 f"{tuple(logits.shape)}, or not finite")
        runs[arch, "serve"] = (run, counts, mem)
        del server
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# serving on the in-process (data x model) mesh
# ---------------------------------------------------------------------------
def mesh_server(model, mesh, opts, groups, sp, io, caches) -> dict:
    """A serve-mesh server (``launch.serve.build_server``'s keys) of
    ``make_serve_fn``'s rank program over per-rank ``sp``, ``io``,
    ``caches``."""
    from repro_torch.pipeline.decode import make_serve_fn

    fn, _, batch_specs = make_serve_fn(model, mesh, opts, groups)
    return dict(model=model, cfg=model.cfg, mesh=mesh, sp=sp, io=io,
                caches=caches, rank_fn=fn, batch_specs=batch_specs)


def mesh_decode(server, first, pos0: int, steps: int, feed=None) -> dict:
    """``steps`` greedy steps of a mesh server's rank program from position
    ``pos0``, fed its own tokens or, from step 1 on, ``feed[t]``.  A step
    is timed from the batch's sharding to the host copy of its tokens,
    with the mesh's collectives and the kernels' launches counted inside
    it; the step's float32 logits are recomputed after it from the last
    stage's output (the operations the program took its argmax of),
    outside the counts.  Under ``sp_mode`` (a replicated batch) every data
    rank must give the same tokens and logits bit for bit."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeRun
    from repro_torch.pipeline.executor import shard_batch

    mesh, model = server["mesh"], server["model"]
    data, S = mesh.shape["data"], model.num_stages
    replicated = next(iter(server["batch_specs"].values())) is None
    heads = [mesh.rank_of(data=i, model=S - 1) for i in range(data)]
    toks, seq = first.to(mesh.device), [first.tolist()]
    logits, launches = [], {}
    run = ServeRun(tokens=[], step_seconds=[])
    for t in range(steps):
        mesh.reset_counts()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        shards = shard_batch(mesh, {"tokens": toks}, server["batch_specs"])
        res = mesh.run(server["rank_fn"], [
            (server["sp"][r], server["io"][r], server["caches"][r],
             shards[r], pos0 + t) for r in range(mesh.size)])
        got = [res[r][0] for r in heads]
        nxt = (got[0] if replicated else torch.cat(got)).tolist()
        run.step_seconds.append(time.perf_counter() - t0)
        run.collectives.append({k: (n, mesh.seconds[k]) for k, n
                                in sorted(mesh.counts.items())})
        for k, n in ops.launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        with torch.inference_mode():
            lg = [model.head_logits(server["io"][r], res[r][1])[:, 0]
                  .float() for r in heads]
        hidden = [res[r][1] for r in heads]
        if replicated:
            if not all(torch.equal(a, got[0]) for a in got) or not all(
                    torch.equal(a, lg[0]) for a in lg):
                raise AssertionError("sp_mode: the data ranks' tokens or "
                                     "logits differ")
            lg, hidden = lg[:1], hidden[:1]
        logits.append(torch.cat(lg).cpu())
        seq.append(nxt)
        toks = torch.tensor(nxt if feed is None else feed[t + 1],
                            device=mesh.device)
    ops.reset_launch_counts()
    run.tokens = [list(row) for row in zip(*seq)]
    return dict(run=run, tokens=seq, logits=torch.stack(logits),
                hidden=torch.cat(hidden).cpu(), launches=launches)


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def seeded_kv(shape, below: int, dtype, device, seed: int) -> dict:
    """The reference's stacked ``k``/``v`` leaves ``[S, l_max, b, seq,
    hkv, hd]`` drawn from one seed below position ``below``, zero at and
    past it (rows not yet written)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k in ("k", "v"):
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        t[:, :, :, below:] = 0
        out[k] = t
    return out


#: the small serve-mesh cases: (label, arch, layers (``cut_depth`` at full
#: width, or ``reduced_config``), reduced, data, stages, batch, cache_len,
#: sp_mode, pos0, tokens, window)
SMALL_SERVE_MESH = [
    ("gemma3-4b sp_mode", "gemma3-4b", 6, False, 2, 2, 1, 256, True, 124, 8,
     16),
    ("deepseek-moe ep", "deepseek-moe-16b", 2, False, 2, 2, 4, 64, False, 20,
     4, None),
    ("deepseek-moe tp (reduced, 8 experts)", "deepseek-moe-16b", 4, True, 2,
     2, 4, 64, False, 20, 4, None)]


def phase_small_serve_mesh():
    """The serve rank program on a mesh of ranks on the card (kernels)
    against the same mesh on the CPU (plain versions), float32, identical
    seeded weights (seed 3) and caches (``k``/``v`` seeded below ``pos0``,
    through ``convert.rank_caches_from_reference``): gemma3-4b at full
    width cut to 6 layers (a global layer among them) under ``sp_mode`` on
    2 x 2, window 16, cache 256 (128 rows a rank), 8 tokens from pos 124,
    so the write and the windows cross the shard; deepseek-moe's dense
    and first MoE layer, ``ep`` on 2 x 2, batch 4; the ``tp`` layout at
    decode on the reduced 8-expert deepseek-moe.  Tokens equal, every
    step's logits and the last hidden state within TOL_MM of their max.
    The data replicas of a device share its read-only weights (but the
    expert shards)."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.build import build, tree_map
    from repro_torch.models.convert import rank_caches_from_reference
    from repro_torch.pipeline.decode import DecodeOptions, cache_specs

    for (label, arch, layers, reduced, data, stages, batch, cache_len,
         sp_mode, pos0, tokens, window) in SMALL_SERVE_MESH:
        cfg = (registry.reduced_config(arch, layers) if reduced
               else small_config(arch, layers))
        if window:
            cfg = dataclasses.replace(cfg, sliding_window=window)
        model = build(cfg, stages)
        opts = DecodeOptions(mb_rows=1, cache_len=cache_len,
                             enc_len=max(1, cache_len // 4), sp_mode=sp_mode)
        groups = 1 if sp_mode else batch // data
        print(f"small serve mesh {label} {cfg.pattern} ({data} x {stages}, "
              f"batch {batch}, cache {cache_len}, {tokens} tokens from pos "
              f"{pos0}, layout {model.moe_layout}), card vs CPU mesh, "
              f"float32:")
        full = [drawn_on_card(lambda d, s=s: model.init_stage_params(
            s, seed=3, device=d)) for s in range(stages)]
        io_cpu = drawn_on_card(lambda d: model.init_io_params(seed=3,
                                                              device=d))
        one = model.init_layer_cache(batch, cache_len, opts.enc_len,
                                     device="cpu")
        fill = tree_map(lambda t: torch.zeros(
            (stages, model.l_max) + tuple(t.shape), dtype=t.dtype), one)
        fill.update(seeded_kv(fill["k"].shape, pos0, cfg.dtype, "cpu", 13))
        shard = model.moe_layout != "none" and data > 1
        first = torch.arange(batch) * 4099 % cfg.vocab_size + 11
        out = {}
        for dev in ("cpu", "cuda"):
            mesh = make_mesh(data, stages, device=dev)
            io = io_cpu if dev == "cpu" else copy.deepcopy(io_cpu).to(dev)
            mods = {}
            sp = []
            for r in range(mesh.size):
                c = mesh.coords(r)
                key = (c["model"], c["data"] if shard else 0)
                if key not in mods:
                    m = (model.shard_stage_params(full[c["model"]], data,
                                                  c["data"]) if shard
                         else full[c["model"]])
                    mods[key] = m if dev == "cpu" else copy.deepcopy(m).to(
                        dev)
                sp.append(mods[key])
            caches = rank_caches_from_reference(
                model, mesh, fill, cache_specs(model, opts), dev)
            server = mesh_server(model, mesh, opts, groups, sp,
                                 [io] * mesh.size, caches)
            t0 = time.perf_counter()
            out[dev] = mesh_decode(server, first, pos0, tokens)
            print(f"  {dev}: tokens {out[dev]['tokens'][1:]}  "
                  f"{time.perf_counter() - t0:.1f} s  collectives a step "
                  f"{ {k: n for k, (n, _) in out[dev]['run'].collectives[-1].items()} }")
            del server, caches, sp, mods
        if out["cuda"]["tokens"] != out["cpu"]["tokens"]:
            raise AssertionError(f"{label}: tokens differ, card "
                                 f"{out['cuda']['tokens']} vs CPU "
                                 f"{out['cpu']['tokens']}")
        errs = [rel_err(out["cuda"][k], out["cpu"][k])
                for k in ("logits", "hidden")]
        if not all(math.isfinite(e) and e <= TOL_MM for e in errs):
            raise AssertionError(f"{label}: logits / last hidden state "
                                 f"{errs} of their max from the CPU's")
        print(f"  tokens equal; every step's logits and the last hidden "
              f"state within {errs[0]:.3e} and {errs[1]:.3e} of their max "
              f"(tolerance {TOL_MM:g})  ok")
        torch.cuda.empty_cache()


def attention_layers(model) -> int:
    from repro_torch.models.build import ATTN_KINDS

    return sum(model.layer_types[t] in ATTN_KINDS
               for t in model.type_ids.ravel() if t >= 0)


def report_mesh_run(label, run, launches, per_step, mem, smi) -> None:
    """Print a mesh serve run's ms per step after the first, peak memory,
    launches per step against ``per_step`` (which they must equal) and
    collectives per step with their host seconds."""
    steps = len(run.step_seconds)
    rest = run.step_seconds[1:]
    got = {k: launches.get(k, 0) / steps for k in per_step}
    print(f"  {label}: first step {run.step_seconds[0]:.3f} s, then "
          f"{sum(rest) / len(rest) * 1e3:.2f} ms/step; peak "
          f"{mem / 2**30:.2f} GiB; launches a step {got} (from the code "
          f"{per_step}); collectives a step (calls, host s summed over "
          f"ranks) {run.collectives[-1] if run.collectives else {}}  "
          f"[{smi}]")
    for k, n in per_step.items():
        if launches.get(k, 0) != n * steps:
            raise AssertionError(f"{label}: {k} launched {launches.get(k)}"
                                 f" times in {steps} steps, the code "
                                 f"gives {n} a step")


#: gemma3-4b's published context (arXiv:2503.19786), split over two data
#: ranks; the two starting positions of its sequence-parallel runs
GEMMA_CACHE = 131072
GEMMA_POSITIONS = (98304, 65532)
MESH_TOKENS = 8
#: float32, the sequence-parallel run against the unsharded one
TOL_SP_F32 = 1e-4


def phase_serve_mesh_path(runs):
    """Serving on the in-process mesh at full size, bf16 (ROADMAP 18c):
    paper-gpt3-large on 2 x 4 through ``launch.serve``
    (``serve_mesh_gpt3``), seamless on 2 x 4 with seeded ``xk``/``xv``
    (``serve_mesh_seamless``), deepseek-moe cut to 4 layers ``ep`` on
    2 x 2 (``serve_mesh_moe``) and gemma3-4b under ``sp_mode`` with its
    128k cache (``serve_mesh_gemma``)."""
    smi = card()
    out = serve_mesh_gpt3(runs, smi)
    out.update(serve_mesh_seamless(smi))
    out.update(serve_mesh_moe(smi))
    out.update(serve_mesh_gemma(smi))
    return out


def launcher_serve(args, server):
    """``launch.serve.serve`` on a built server, between zeroed and read
    launch counts and peak memory: (run, launches, peak bytes)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.serve(args, server=server)
    counts = ops.launch_counts()
    return run, counts, torch.cuda.max_memory_allocated()


def serve_mesh_gpt3(runs, smi) -> dict:
    """paper-gpt3-large full size on 2 x 4 (batch 8, 4 one-row groups a
    data rank, cache 4096) through ``launch.serve --devices 8``: the 1 x 4
    serve run's tokens, launches as counted, and one more decode pass per
    data rank whose last hidden state is compared with the 1 x 4 run's
    (printed: bitwise is expected, each row its own one-row group in both
    runs)."""
    import torch

    from repro_torch.launch import serve

    arch = "paper-gpt3-large"
    argv = (["--arch", arch, "--tokens", str(MESH_TOKENS), "--devices", "8"]
            + SERVE_ARGS)
    print(f"serve mesh {arch}: python -m repro_torch.launch.serve "
          + " ".join(argv))
    args = serve.parser().parse_args(argv)
    server = serve.build_server(arch, stages=4, layers=None, batch=8,
                                cache_len=4096, reduced=False, device="cuda",
                                seed=args.seed, data=2)
    run, counts, mem = launcher_serve(args, server)
    model, mesh = server["model"], server["mesh"]
    report_mesh_run(f"{arch} 2 x 4", run, counts, serve_launches(model, 8),
                    mem, smi)
    want = runs[arch, "serve"][0].tokens
    if run.tokens != want:
        raise AssertionError(f"{arch} 2 x 4 tokens {run.tokens} differ "
                             f"from the 1 x 4 run's {want}")
    hs = []
    for i in range(2):
        ranks = [mesh.rank_of(data=i, model=s) for s in range(4)]
        toks = torch.tensor([row[-1] for row in run.tokens[4 * i:4 * i + 4]],
                            device="cuda")
        hs.append(decode_pass(model, [server["sp"][r] for r in ranks],
                              server["io"][ranks[0]],
                              [server["caches"][r] for r in ranks], toks,
                              MESH_TOKENS)[0])
    h, ref = torch.cat(hs).cpu(), SERVE_HIDDEN[arch]
    err = float((h.float() - ref.float()).abs().max())
    if not math.isfinite(err):
        raise AssertionError(f"{arch}: non-finite hidden state")
    print(f"  tokens equal to the 1 x 4 run's; one more pass's last hidden "
          f"state against the 1 x 4 run's: "
          + ("bit for bit" if torch.equal(h, ref) else f"max |diff| {err}"))
    return {(arch, "serve 2x4"): (run, counts, mem)}


def serve_mesh_seamless(smi) -> dict:
    """seamless-m4t-large-v2 full size (batch 8, cache 4096, enc_len 1024)
    on 1 x 4 (the staircase) and twice on 2 x 4 through ``launch.serve``,
    each from the same caches (``xk``/``xv`` drawn from one seed, through
    ``convert``): the 2 x 4 run's tokens the 1 x 4 run's, its rerun's
    tokens and written cache rows bit for bit, K2 and K3 launches as
    counted, and K3's per-stream arrival counters back at 0 after eight
    rank threads launched it on the one default stream."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_decode
    from repro_torch.launch import serve
    from repro_torch.models.build import tree_map
    from repro_torch.models.convert import (
        cache_from_reference,
        rank_caches_from_reference,
    )
    from repro_torch.pipeline.decode import DecodeOptions, cache_specs

    arch = "seamless-m4t-large-v2"
    cfg = registry.get_arch(arch)
    args = serve.parser().parse_args(
        ["--arch", arch, "--tokens", str(MESH_TOKENS)] + SERVE_ARGS)
    enc = 4096 // 4
    opts = DecodeOptions(mb_rows=1, cache_len=4096, enc_len=enc)
    runs, out = [], {}
    for data in (1, 2, 2):
        server = serve.build_server(arch, stages=4, layers=None, batch=8,
                                    cache_len=4096, reduced=False,
                                    device="cuda", seed=args.seed, data=data)
        model = server["model"]
        gen = torch.Generator(device="cuda").manual_seed(17)
        lead, kv = (4, model.l_max, 8), (cfg.num_kv_heads,
                                         cfg.resolved_head_dim)
        fill = {k: torch.zeros((1,), dtype=cfg.dtype, device="cuda").expand(
            lead + (4096,) + kv) for k in ("k", "v")}
        fill.update({k: torch.randn(lead + (enc,) + kv, generator=gen,
                                    dtype=cfg.dtype, device="cuda")
                     for k in ("xk", "xv")})
        server["caches"] = (
            cache_from_reference(model, fill, "cuda") if data == 1 else
            rank_caches_from_reference(model, server["mesh"], fill,
                                       cache_specs(model, opts), "cuda"))
        del fill
        run, counts, mem = launcher_serve(args, server)
        again = " again" if len(runs) == 2 else ""
        report_mesh_run(f"{arch} {data} x 4{again}", run, counts,
                        serve_launches(model, 8), mem, smi)
        busy = [k for k, t in flash_decode._COUNTERS.items()
                if int(t.abs().sum())]
        if busy:
            raise AssertionError(f"K3 arrival counters not back at 0: "
                                 f"{busy}")
        runs.append((run, [tree_map(
            lambda c: c[:, :, :MESH_TOKENS + 1].clone(),
            {k: c[k] for k in ("k", "v")}) for c in server["caches"]]))
        if data == 2:
            out[arch, f"serve 2x4{again}"] = (run, counts, mem)
        del server
        torch.cuda.empty_cache()
    (one, _), (a, wa), (b, wb) = runs
    if a.tokens != one.tokens:
        raise AssertionError(f"{arch} 2 x 4 tokens {a.tokens} differ from "
                             f"the 1 x 4 run's {one.tokens}")
    if b.tokens != a.tokens or not all(
            torch.equal(x[k], y[k]) for x, y in zip(wa, wb)
            for k in ("k", "v")):
        raise AssertionError(f"{arch} 2 x 4: the rerun differs")
    print(f"  {arch}: 2 x 4 tokens equal to the 1 x 4 run's; the rerun's "
          f"tokens and written cache rows bit for bit; K3's arrival "
          f"counters at 0")
    return out


def serve_mesh_moe(smi) -> dict:
    """deepseek-moe-16b at full width cut to 4 layers, ``ep`` on 2 x 2
    (batch 8, 4 one-row groups a data rank, cache 4096, 8 tokens), twice
    from zeroed caches: finite logits, the rerun's tokens and logits bit
    for bit, ``all_to_all`` a step as counted (2 per MoE layer and group
    on each data rank) and K2 launches as counted."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models.build import tree_map

    arch = "deepseek-moe-16b"
    cfg = registry.cut_depth(arch, 4)
    server = serve.build_server(arch, stages=2, layers=None, batch=8,
                                cache_len=4096, reduced=False, device="cuda",
                                seed=0, cfg=cfg, data=2)
    model = server["model"]
    first = torch.randint(0, cfg.vocab_size, (8,),
                          generator=torch.Generator().manual_seed(7))
    n_moe = sum(model.layer_types[t] == "moe"
                for t in model.type_ids.ravel() if t >= 0)
    a2a = 2 * n_moe * 8  # F 2 per MoE layer and one-row group, every row
    moe = []
    for _ in range(2):
        for c in server["caches"]:
            tree_map(lambda t: t.zero_(), c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        moe.append(mesh_decode(server, first, 0, MESH_TOKENS))
        mem = torch.cuda.max_memory_allocated()
        report_mesh_run(f"{arch} (4 layers) ep 2 x 2", moe[-1]["run"],
                        moe[-1]["launches"], serve_launches(model, 8), mem,
                        smi)
        for c in moe[-1]["run"].collectives:
            if c.get("all_to_all", (0,))[0] != a2a:
                raise AssertionError(f"{arch}: all_to_all a step {c}, the "
                                     f"code gives {a2a}")
    a, b = moe
    if not torch.isfinite(a["logits"]).all():
        raise AssertionError(f"{arch}: non-finite logits")
    if a["tokens"] != b["tokens"] or not torch.equal(a["logits"],
                                                      b["logits"]):
        raise AssertionError(f"{arch}: the rerun differs")
    print(f"  {arch}: finite logits; all_to_all {a2a} a step as counted; "
          f"the rerun's tokens and logits bit for bit")
    del server
    torch.cuda.empty_cache()
    return {(arch, "serve ep 2x2"): (a["run"], a["launches"], mem)}


def gemma_runs(cfg, stages: int, plans, tokens: int, smi, cell=None):
    """gemma3-4b serve runs at cache GEMMA_CACHE, batch 1, from each of
    GEMMA_POSITIONS, one mesh per plan ``(label, data, sp_mode, reruns)``,
    every one from the same seeded cache (``k``/``v`` drawn below the
    first position through ``convert.rank_caches_from_reference``; rows at
    and past a run's position zeroed before it).  The first plan is the
    unsharded run; the others are fed its tokens.  Each run's launches
    and collectives a step must be as counted; ``reruns`` runs the last
    position again, which must give the same bits.  ``cell``, a
    ``launch.cells`` plan of the last plan's mesh: after the last plan's
    runs, its ``build_cell`` step function serves from each position again
    on the same weights and caches, and must give that plan's tokens and
    logits bit for bit.  Returns the runs by (label, pos) and the entries
    for ``main``'s record."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import rank_params
    from repro_torch.models.build import build
    from repro_torch.models.convert import rank_caches_from_reference
    from repro_torch.pipeline.decode import DecodeOptions, cache_specs

    model = build(cfg, stages)
    L = GEMMA_CACHE
    fill = seeded_kv((stages, model.l_max, 1, L, cfg.num_kv_heads,
                      cfg.resolved_head_dim), max(GEMMA_POSITIONS),
                     cfg.dtype, "cuda", 21)
    first = torch.tensor([1234 % cfg.vocab_size])
    layers, per_rank = attention_layers(model), serve_launches(model, 1)
    res, out = {}, {}
    for k, (label, data, sp_mode, reruns) in enumerate(plans):
        opts = DecodeOptions(mb_rows=1, cache_len=L, sp_mode=sp_mode)
        mesh = make_mesh(data, stages, device="cuda")
        caches = rank_caches_from_reference(model, mesh, fill,
                                            cache_specs(model, opts), "cuda")
        if k == len(plans) - 1:
            del fill
            torch.cuda.empty_cache()
        sp, io = rank_params(model, mesh, seed=0, device="cuda")
        servers = {label: mesh_server(model, mesh, opts, 1, sp, io, caches)}
        shard = L // data
        want = {"ppermute": mesh.size * stages, "psum": mesh.size}
        if sp_mode:
            want.update(pmax=data * layers,
                        psum=2 * data * layers + mesh.size)
        via_cell = cell is not None and k == len(plans) - 1
        if via_cell:
            from repro_torch.launch import cells

            fn, _, specs = cells.build_cell(cell, mesh)
            servers["cell"] = dict(servers[label], rank_fn=fn,
                                   batch_specs=specs)
        # (pos, server tag, again): the cell's run right after the plan's own
        # from the same position, before a run from a lower position
        # writes rows the higher one reads
        runs = [r for pos in GEMMA_POSITIONS for r in
                [(pos, label, False)] + [(pos, "cell", False)] * via_cell]
        runs += [(GEMMA_POSITIONS[-1], label, True)] * reruns
        for pos, tag, again in runs:
            for r, c in enumerate(caches):  # rows at and past pos unwritten
                start = max(0, pos - mesh.coords(r)["data"] * shard)
                for name in ("k", "v"):
                    c[name][:, :, start:] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            feed = None if k == 0 else res[plans[0][0], pos]["tokens"]
            run = mesh_decode(servers[tag], first, pos, tokens, feed=feed)
            mem = torch.cuda.max_memory_allocated()
            name = (f"gemma3-4b {cfg.num_layers} layers {label} "
                    f"{data} x {stages} from pos {pos}"
                    + (" again" if again else "")
                    + (" through launch.cells.build_cell"
                       if tag == "cell" else ""))
            report_mesh_run(name, run["run"], run["launches"],
                            {n: v * data for n, v in per_rank.items()},
                            mem, smi)
            for c in run["run"].collectives:
                got = {n: c.get(n, (0,))[0] for n in want}
                if got != want:
                    raise AssertionError(f"{name}: collectives {got}, "
                                         f"the code gives {want}")
            if again or tag == "cell":
                last = res[label, pos]
                if run["tokens"] != last["tokens"] or not torch.equal(
                        run["logits"], last["logits"]):
                    raise AssertionError(f"{name}: the tokens or logits "
                                         f"differ from the {label} run's")
                print(f"  {name}: bit for bit the {label} run (tokens "
                      f"{run['tokens'][1:]})")
                if tag == "cell":
                    out["gemma3-4b", f"serve long_500k cell {data}x{stages} "
                        f"pos {pos}"] = (run["run"], run["launches"], mem)
                continue
            res[label, pos] = run
            out["gemma3-4b", f"serve {cfg.num_layers}L {label} "
                f"{data}x{stages} pos {pos}"] = (run["run"],
                                                run["launches"], mem)
        del servers, caches, sp, io
        torch.cuda.empty_cache()
    return res, out


def logit_errors(run, ref) -> list[float]:
    """Each step's max |logits - ref logits| over max |ref logits|."""
    return [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(run["logits"], ref["logits"])]


def serve_mesh_gemma(smi) -> dict:
    """gemma3-4b under ``sp_mode`` with its 131,072-token cache split over
    two data ranks, against the unsharded run (one data rank, the plain
    ``decode_attention``), each from pos 98,304 (rank 0's shard all
    valid, on the local layers fully masked) and 65,532 (the write and
    the windows cross the ranks), every run from the same seeded cache:

    * float32, full width cut to 6 layers (5 local, 1 global) on 2 stages,
      4 tokens: tokens equal and every step's logits within TOL_SP_F32 of
      their max (the sequence-parallel decode's arithmetic at the full
      context);
    * bf16 at full width and depth (34 layers, 4 stages), 8 tokens: the
      unsharded run, the same cache whole on one data rank through the
      sequence-parallel formula (``sp_mode`` on 1 x 4: the floor that a
      reformulation of the attention alone moves bf16 logits by, through
      34 layers of seeded weights), and ``sp_mode`` on 2 x 4, rerun once.
      The 2 x 4 run's logits within twice the floor's largest error of
      the unsharded run's; its greedy tokens equal but where the
      unsharded run's top two logits lie within that step's error
      (printed); the rerun bit for bit; ``pmax``/``psum`` a step as
      counted (3 a layer and data rank, and the tokens' psum over
      ``model`` on every rank);
    * the ``long_500k`` cell (ROADMAP 18d): ``launch.cells.plan_cell`` on
      2 x 4 plans it under ``sp_mode`` (batch 1 under two data ranks), its
      cache cut to GEMMA_CACHE; its ``build_cell`` step function serves
      from both positions on the ``sp_mode`` run's weights and caches and
      gives that run's tokens and logits bit for bit."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_mesh

    print(f"serve mesh gemma3-4b, batch 1, cache {GEMMA_CACHE}: unsharded "
          f"vs sp_mode over 2 data ranks, from each of {GEMMA_POSITIONS}:")
    out = {}
    g6 = dataclasses.replace(registry.cut_depth("gemma3-4b", 6),
                             dtype=torch.float32)
    res, o = gemma_runs(g6, 2, [("unsharded", 1, False, 0),
                                ("sp_mode", 2, True, 0)], 4, smi)
    out.update(o)
    for pos in GEMMA_POSITIONS:
        un, sh = res["unsharded", pos], res["sp_mode", pos]
        errs = logit_errors(sh, un)
        print(f"  float32 6 layers from pos {pos}: tokens {un['tokens'][1:]}"
              f" (unsharded) {sh['tokens'][1:]} (sp_mode); logits within "
              f"{max(errs):.3e} of their max (tolerance {TOL_SP_F32:g})")
        if sh["tokens"] != un["tokens"] or not all(
                math.isfinite(e) and e <= TOL_SP_F32 for e in errs):
            raise AssertionError(f"gemma3-4b float32 pos {pos}: sp_mode "
                                 f"departs from the unsharded run")
    g = registry.get_arch("gemma3-4b")
    # the long_500k cell as launch.cells plans it on 2 x 4 (batch 1 under
    # two data ranks: sp_mode), its cache cut to GEMMA_CACHE rows
    cell = cells.plan_cell("gemma3-4b", "long_500k",
                           make_mesh(2, 4, device="cuda"), num_stages=4)
    print(f"  the gemma3-4b x long_500k cell on 2 x 4: sp_mode "
          f"{cell.sp_mode}, {cell.num_microbatches} group of "
          f"{cell.mb_rows} row, cache {cell.cell.seq_len} cut to "
          f"{GEMMA_CACHE}")
    if not cell.sp_mode:
        raise AssertionError("plan_cell did not plan gemma3-4b x long_500k "
                             "under sp_mode")
    cell = dataclasses.replace(cell, seq_len=GEMMA_CACHE, cell=dataclasses
                               .replace(cell.cell, seq_len=GEMMA_CACHE))
    res, o = gemma_runs(g, 4,
                        [("unsharded", 1, False, 0),
                         ("one shard", 1, True, 0),
                         ("sp_mode", 2, True, 1)], MESH_TOKENS, smi,
                        cell=cell)
    out.update(o)
    floor = max(e for pos in GEMMA_POSITIONS for e in logit_errors(
        res["one shard", pos], res["unsharded", pos]))
    for pos in GEMMA_POSITIONS:
        un, sh = res["unsharded", pos], res["sp_mode", pos]
        errs = logit_errors(sh, un)
        print(f"  bf16 {g.num_layers} layers from pos {pos}: tokens "
              f"{un['tokens'][1:]} "
              f"(unsharded) {sh['tokens'][1:]} (sp_mode); logits "
              f"{['%.2e' % e for e in errs]} of their max (the one-shard "
              f"floor at most {floor:.3e}, tolerance twice it)")
        if not all(math.isfinite(e) and e <= max(2 * floor, TOL_SP_F32)
                   for e in errs):
            raise AssertionError(f"gemma3-4b bf16 pos {pos}: logits beyond "
                                 f"twice the one-shard floor {floor:.3e}")
        for t, e in enumerate(errs):
            ta, tb = sh["tokens"][t + 1], un["tokens"][t + 1]
            if ta == tb:
                continue
            b = un["logits"][t, 0]
            top = torch.topk(b, 2).values
            gap = float(top[0] - top[1]) / float(b.abs().max())
            print(f"    step {t}: token {ta} vs unsharded {tb}, whose top "
                  f"two logits are {gap:.3e} of the max apart (the step's "
                  f"error {e:.3e})")
            if gap > e:
                raise AssertionError(f"gemma3-4b bf16 pos {pos} step {t}: "
                                     f"tokens differ off a near tie")
    return out


def phase_serve_procs_path(runs):
    """``serve --procs`` (``launch.serve.serve_procs``): paper-gpt3-large
    at full size on 2 x 4, eight processes (gloo, payloads staged through
    host memory), batch 8, cache 4096, MESH_TOKENS tokens, every rank
    warmed at once first (``pipeline/decode.make_warm_fn``).  Its tokens
    must be bit for bit those of ``serve_mesh_gpt3``'s thread run (which
    equal the 1 x 4 run's), its collectives a step, summed over the
    processes, the thread run's, and K2 launched as ``serve_launches``
    counts a step, summed over the processes, plus the warm-up's (one
    one-row group a data rank).  Prints the warm-up, the first step,
    ms/step, each process's peak and the card's largest ``memory.used``;
    ``--dist-backend nccl`` with 8 ranks on one card stops before a world
    starts."""
    import gc

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models.build import build

    gc.collect()
    torch.cuda.empty_cache()
    smi = card()
    arch = "paper-gpt3-large"
    argv = (["--arch", arch, "--tokens", str(MESH_TOKENS), "--devices", "8",
             "--procs"] + SERVE_ARGS)
    print(f"serve procs {arch}: python -m repro_torch.launch.serve "
          + " ".join(argv))
    args = serve.parser().parse_args(argv)
    before_spawn()
    t0 = time.perf_counter()
    with memory_used() as used:
        run = serve.serve(args)
    wall = time.perf_counter() - t0
    thread = runs[arch, "serve 2x4"][0]
    if run.tokens != thread.tokens:
        raise AssertionError(f"{arch} 2 x 4 --procs tokens {run.tokens} "
                             f"differ from the thread run's {thread.tokens}")

    def calls(r):
        return [{k: n for k, (n, _) in step.items()}
                for step in r.collectives]

    if calls(run) != calls(thread):
        raise AssertionError(f"{arch} 2 x 4 --procs collectives "
                             f"{calls(run)}, threads {calls(thread)}")
    model = build(registry.get_arch(arch), num_stages=4)
    per_step, warm = serve_launches(model, 8), serve_launches(model, 2)
    want = {k: MESH_TOKENS * n + warm[k] for k, n in per_step.items()}
    counts = {k: sum(r["launches"][k] for r in run.ranks)
              for k in run.ranks[0]["launches"]}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"{arch} 2 x 4 --procs launched {counts}, the "
                             f"code counts {want}")
    peaks = [r["peak_bytes"] for r in run.ranks]
    rest = run.step_seconds[1:]
    print(f"  {arch} 2 x 4 --procs: warm-up {run.warm_seconds:.3f} s, first "
          f"step {run.step_seconds[0]:.3f} s, then "
          f"{sum(rest) / len(rest) * 1e3:.2f} ms/step (threads: first "
          f"{thread.step_seconds[0]:.3f} s, then "
          f"{sum(thread.step_seconds[1:]) / len(rest) * 1e3:.2f} ms/step); "
          f"step s {run.step_seconds}; {wall:.1f} s with the spawn  [{smi}]")
    print(f"  tokens bit for bit the thread run's; collectives a step "
          f"{calls(run)[-1]} (host s summed over the 8 processes: "
          f"{ {k: round(sec, 3) for k, (_, sec) in run.collectives[-1].items()} }"
          f"), the thread run's; launches summed over the processes "
          f"{counts} (from the code: {MESH_TOKENS} steps x {per_step} and "
          f"the warm-up's {warm})")
    print("  peak memory a process (GiB): " + ", ".join(
        f"rank {r['rank']} {r['peak_bytes'] / 2**30:.2f}" for r in run.ranks)
        + f"; sum {sum(peaks) / 2**30:.2f}; card memory.used at most "
        f"{max(used, default=0)} MiB")
    try:
        serve.main(argv + ["--dist-backend", "nccl"])
    except SystemExit as e:
        if "8 ranks on 1 card(s)" not in str(e):
            raise AssertionError(f"--dist-backend nccl stopped with {e}")
        print(f"  --dist-backend nccl, 8 ranks: SystemExit ({e})")
    else:
        raise AssertionError("serve --procs --dist-backend nccl with 8 "
                             "ranks on one card did not stop")
    return {(arch, "serve 2x4 procs"): (run, counts, max(peaks))}


#: train_lm's steps on the card (its reference runs 200; ~4 s a step of
#: the thread mesh here): its loss must fall, the reference example's
#: assertion
EXAMPLE_LM_STEPS = 4


def phase_examples():
    """The port's counterparts of the reference's four JAX-calling
    examples (``repro_torch.examples``), each through its ``main`` on
    ``cuda`` at the reference's sizes (train_lm at EXAMPLE_LM_STEPS
    steps), between zeroed and read launch counts: quickstart (the
    engine's 1F1B-vs-RRFP contrast, then 5 rrfp table steps of reduced
    deepseek-7b on a 2 x 4 mesh of rank threads: K1 float32 at head_dim
    16, K2), serve_batch (24 greedy tokens, batch 8, on 2 x 4: K2),
    train_lm (the custom 256-wide LM on 2 x 4, ZeRO-1 AdamW with warm-up:
    K1 float32 at head_dim 64, K2; its loss falls, which ``main``
    asserts) and async_runtime (the simulated transport, then 3 steps of
    thread-per-stage actors: K1, K2).  Each run launches K1 and K2
    exactly as ``table_launches`` / ``serve_launches`` count them; losses
    finite, tokens in the vocabulary."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core.taskgraph import PipelineSpec
    from repro_torch.examples import async_runtime, quickstart, serve_batch
    from repro_torch.examples import train_lm
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeRun
    from repro_torch.launch.train import TrainRun
    from repro_torch.models.build import build
    from repro_torch.pipeline import schedules
    from repro_torch.pipeline.spec import OP_B, OP_F

    def launched(name, fn, argv):
        print(f"example {name}: python -m repro_torch.examples.{name} "
              + " ".join(argv))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(argv)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        print(f"  {name}: {wall:.1f} s, launches {counts}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return out, counts, torch.cuda.max_memory_allocated(), wall

    def expect(name, counts, want):
        print(f"  {name}: launches from the code {want}")
        if any(counts[k] != n for k, n in want.items()) or not all(want.values()):
            raise AssertionError(f"example {name} launched {counts}, the "
                                 f"code counts {want}")

    deepseek = registry.reduced_config("deepseek-7b", num_layers=8)
    out = {}
    q, counts, mem, wall = launched("quickstart", quickstart.main,
                                    ["--device", "cuda"])
    model = build(deepseek, num_stages=4)
    per = table_launches(model, schedules.rrfp(PipelineSpec(4, 8)), 2)
    expect("quickstart", counts, {k: 5 * n for k, n in per.items()})
    if not (len(q["losses"]) == 5 and all(map(math.isfinite, q["losses"]))
            and q["rrfp"].makespan < q["fixed"].makespan):
        raise AssertionError(f"quickstart: losses {q['losses']}, makespans "
                             f"{q['fixed'].makespan} / {q['rrfp'].makespan}")
    out["example", "quickstart"] = (
        TrainRun(losses=q["losses"], step_seconds=[wall]), counts, mem)

    rows, counts, mem, wall = launched("serve_batch", serve_batch.main,
                                       ["--device", "cuda"])
    expect("serve_batch", counts, {"rmsnorm": 24 * serve_launches(
        model, 8)["rmsnorm"]})
    if not all(0 <= t < deepseek.vocab_size for r in rows for t in r):
        raise AssertionError(f"serve_batch: tokens {rows}")
    out["example", "serve_batch"] = (
        ServeRun(tokens=rows, step_seconds=[wall]), counts, mem)

    argv = ["--device", "cuda", "--steps", str(EXAMPLE_LM_STEPS)]
    losses, counts, mem, wall = launched("train_lm", train_lm.main, argv)
    lm = build(train_lm.lm_config(256, 8, False), num_stages=4)
    per = table_launches(lm, schedules.rrfp(PipelineSpec(4, 8)), 2)
    expect("train_lm", counts,
           {k: EXAMPLE_LM_STEPS * n for k, n in per.items()})
    print(f"  train_lm losses {losses}: {losses[0]} -> {losses[-1]}")
    out["example", "train_lm"] = (
        TrainRun(losses=losses, step_seconds=[wall]), counts, mem)

    a, counts, mem, wall = launched("async_runtime", async_runtime.main,
                                    ["--device", "cuda"])
    small = build(registry.reduced_config("deepseek-7b", num_layers=4), 2)
    fb = fused_table([[OP_F] * 4 + [OP_B] * 4] * 2)  # 4 microbatches
    expect("async_runtime", counts,
           {k: 3 * n for k, n in table_launches(small, fb, 1).items()})
    if not all(map(math.isfinite, a["losses"])):
        raise AssertionError(f"async_runtime: losses {a['losses']}")
    out["example", "async_runtime"] = (
        TrainRun(losses=a["losses"], step_seconds=[wall]), counts, mem)
    ops.reset_launch_counts()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    import triton

    print(f"card: {smi}  ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}  triton {triton.__version__}")

    t0 = time.perf_counter()
    secs = _build.build_all(["flash_attention", "ssd_scan", "flash_decode"])
    for name, (s, log) in _build.BUILD_LOG.items():
        print(f"built {name}.cu in {s:.1f} s" + (f"\n{log}" if log.strip()
                                                  else ""))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({'reused' if not secs else 'compiled'})")
    if "flash_attention" in _build.BUILD_LOG:  # K1 at head_dim 256
        n = check_no_spills(_build.BUILD_LOG["flash_attention"][1],
                            "flash_fwd_kernelILi256E")
        print(f"K1 head_dim 256: {n} instantiations, no ptxas spills")
        n = check_no_spills(_build.BUILD_LOG["flash_attention"][1],
                            "flash_bwd")
        print(f"K1b: {n} kernel instantiations, no ptxas spills")

    seconds = {"build": time.perf_counter() - t0}

    def timed(fn, *args):
        """Run phase ``fn(*args)``; print its wall time as it ends."""
        t1 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__] = time.perf_counter() - t1
        print(f"phase {fn.__name__}: {seconds[fn.__name__]:.1f} s",
              flush=True)
        return out

    record: dict = {}
    for fn in (phase_attention, phase_attention_bwd, phase_rmsnorm, phase_ssd,
               phase_decode):
        timed(fn, record)
    if "--kernels-only" in argv:
        return 0
    for fn in (phase_small_model, phase_small_multimodal, phase_small_serve,
               phase_small_table, phase_small_serve_mesh):
        timed(fn)
    host_draw_seconds()
    runs = timed(phase_main_path)
    torch.cuda.empty_cache()
    runs.update(timed(phase_table_path, runs))
    runs.update(timed(phase_moe_table_path))
    runs.update(timed(phase_procs_path, runs))
    for fn in (phase_enc_dec_table_path, phase_cells_path,
               phase_runtime_flags, phase_multimodal_path, phase_serve_path):
        runs.update(timed(fn))
    runs.update(timed(phase_serve_mesh_path, runs))
    torch.cuda.empty_cache()
    runs.update(timed(phase_serve_procs_path, runs))
    runs.update(timed(phase_examples))
    kernels = []
    for name, rec in record.items():
        by_path = {f"{arch} {run}": c.get(name, 0) for (arch, run), (_, c, _)
                   in runs.items()}
        kernels.append({**rec, "launches": sum(by_path.values()),
                        "launches_by_path": by_path})
    out = {"kernels": kernels}
    summary = {**out, "card": smi,
               "main_path": {f"{arch} {name}": {
                   **({"tokens": r.tokens} if name.startswith("serve")
                      else {"losses": r.losses}),
                   "step_seconds": r.step_seconds,
                   "launches": c, "peak_memory_bytes": mem}
                   for (arch, name), (r, c, mem) in runs.items()}}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(
        json.dumps(summary, indent=1))
    print("phases by wall time (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(seconds.items(),
                                           key=lambda kv: -kv[1])))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
