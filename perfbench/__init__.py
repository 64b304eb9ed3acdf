"""The benchmark of the PyTorch and CUDA port (``spef_tpu_torch``) on one
NVIDIA H100: ``perfbench/run.py`` runs one cell of ``BENCHMARK.json``."""
