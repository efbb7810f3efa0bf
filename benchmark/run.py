"""The benchmark of proton_tpu_torch, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for (BENCHMARK.json). The last line of standard output is the result; the
last lines of standard error are the numbers compared, each beside its
limit. Exit codes: 2 a run that cannot be made (no card, an unknown cell
or a missing file), 3 JAX or the JAX package loaded in the process.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fixed cache directories inside the checkout, so that only the first run
# of a checkout builds or compiles, and two checkouts share nothing
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(ROOT, "build", "bench_cache", _sub)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "4"

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from pathlib import Path

    from benchmark import harness
    sys.exit(harness.main(sys.argv[1:], T_START, Path(ROOT)))
