"""The port's benchmarks (counterparts of the reference's ``benchmarks/``),
run with ``python -m repro_torch.benchmarks.<name>``.  Their artifacts go
to the gitignored ``build/``, never over the reference's committed
``BENCH_*.json``."""
