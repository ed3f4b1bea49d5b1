"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command, ``python3 bstbench/run.py``, cells named in ``BENCHMARK.json``."""
