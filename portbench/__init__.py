"""The benchmark of `agents_tpu_torch` on one NVIDIA H100: `run.py` runs
one cell of ``BENCHMARK.json`` once; see ``README.md``."""
