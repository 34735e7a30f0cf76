"""Benchmark of the MiniConv split-policy port (``repro_torch``) on one
H100: ``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  See ``harness`` for what a run does."""
