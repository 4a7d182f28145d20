"""The benchmark of tailored_avsr_tpu_torch on one H100.

python3 avsr_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (the last of standard output); see README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# libraries the program uses must not load JAX on their own
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# caches inside the checkout, at fixed paths (the kernels build into build/kernels)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "avsr_bench", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "avsr_bench", "torch_extensions")
sys.path[:0] = [HERE, ROOT]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
