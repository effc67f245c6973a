"""One run of one benchmark cell on the CUDA card(s) of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  `--trace 0` measures the cell's end-to-end
metrics over a window of `--seconds`; `--trace 1` traces a fixed number of
units and reads the per-layer metrics.  Both check the window's output
against the plain reference and print, as the last line of standard
output, one JSON object (see `harness.py`).  Exits non-zero without a
result when the card is missing or a forbidden module was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# kernel caches at fixed paths inside the checkout, so only a checkout's
# first run builds; no library the port uses may load JAX by itself
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench_cache" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
