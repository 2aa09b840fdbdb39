"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one run of
one cell is ``python3 rrfp_bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``."""
