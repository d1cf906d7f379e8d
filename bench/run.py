"""Run one cell of the benchmark once and print its result line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The cells, metrics and bounds are BENCHMARK.json's; see PERF.md. Exits
with 2, printing no result, without the CUDA devices the cell asks for.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE.parent / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE))

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
