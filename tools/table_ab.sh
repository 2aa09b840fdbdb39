#!/bin/bash
# Time two checkouts of the repo on the same card, in turns (A, B, B, A):
# the seamless table cell (24 + 24 layers, 1 x 4, 1f1b) and the gpt3 table
# cell on 2 x 4, each through chip_smoke.py's table_run, 2 steps.
#
#   bash tools/table_ab.sh DIR_A DIR_B
#
# DIR_A and DIR_B are checkouts (e.g. `git archive` of the parent and of
# the change, unpacked under build/).  Prints the card, then one line
# "AB <dir> <cell> <step seconds> <peak GiB>" per run.
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for dir in "$1" "$2" "$2" "$1"; do
  (cd "$dir" && python3 - "$dir" <<'PY'
import gc, sys
sys.path.insert(0, "src")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from repro_torch.kernels import _build
_build.build_all(["flash_attention"])
for cell, argv in (("seamless", cs.ENC_DEC_TABLE_ARGS),
                   ("gpt3 2x4", cs.TABLE_ARGS + cs.TABLE_RUNS[-1][1])):
    run, _, mem = cs.table_run(cell, sys.argv[1], argv)
    print("AB", sys.argv[1], cell, run.step_seconds, mem / 2**30, flush=True)
    run = None
    gc.collect()
    torch.cuda.empty_cache()
PY
  )
done
