#!/bin/bash
# Time the serve step of one data rank (the staircase) of two checkouts of
# the repo on the same card, in turns (A, B, B, A): paper-gpt3-large and
# seamless-m4t-large-v2 at full size through launch.serve, 4 stages,
# batch 8, cache 4096, 8 tokens.
#
#   bash tools/serve_ab.sh DIR_A DIR_B
#
# DIR_A and DIR_B are checkouts (e.g. `git archive` of the parent and of
# the change, unpacked under build/).  Prints the card, then one line
# "AB <dir> <arch> <ms a step after the first> <tokens>" per run.
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for dir in "$1" "$2" "$2" "$1"; do
  (cd "$dir" && python3 - "$dir" <<'PY'
import sys
sys.path.insert(0, "src")
import torch
from repro_torch.launch import serve
for arch in ("paper-gpt3-large", "seamless-m4t-large-v2"):
    run = serve.main(["--arch", arch, "--full-size", "--stages", "4",
                      "--batch", "8", "--tokens", "8", "--cache-len", "4096"])
    rest = run.step_seconds[1:]
    print("AB", sys.argv[1], arch, sum(rest) / len(rest) * 1e3, run.tokens,
          flush=True)
    torch.cuda.empty_cache()
PY
  )
done
