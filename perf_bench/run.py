"""Run one cell of the benchmark of the PyTorch and CUDA port:

    python3 perf_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for
(``BENCHMARK.json``).  The last line of standard output is the result; the
numbers compared with the plain reference, each with its limit, are the
last lines of standard error.  Exits nonzero with no result where a card is
missing or the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    # the program builds its kernels into build/kernels/ of the checkout;
    # any other compiler cache stays in the checkout too, at fixed paths
    cache = ROOT / "build" / "perf_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # the script's own folder would shadow standard modules by name
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "perf_bench"]
    from perf_bench.harness import main
    sys.exit(main(sys.argv[1:], t_start=T_START))
