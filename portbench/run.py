"""Run one cell of BENCHMARK.json once and print its result line:

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Exits with another code than 0, and prints no result, where there is no
CUDA device (or fewer than the cell asks for), where the checkout has no
port, and where the run loaded JAX or the JAX package.
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches the port or its libraries may write, at fixed paths inside the
# checkout (the port's own kernel builds go to its _build directory)
_CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
