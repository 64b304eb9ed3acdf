"""Run one cell of the benchmark from the checkout's root:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells are ``BENCHMARK.json``'s ``workloads``; the last line of standard
output is the run's result as one JSON object.
"""

import time

T_START = time.perf_counter()  # the process's start, as near as Python sees it

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Build and kernel caches at fixed paths inside the checkout; no library the
# port loads may bring in JAX by itself.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
os.environ.setdefault("USE_FLAX", "0")

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
