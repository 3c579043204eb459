"""Give each test worker its share of the CPUs.

pytest loads this file in every process that runs tests, before it collects
any module, so ``OMP_NUM_THREADS`` is set before the first ``import torch``
(``perf_bench/test_*.py`` imports torch at collection, before
``tests/conftest.py`` is loaded), and torch sizes its intra-op pool from it.
Under ``pytest -n N`` every xdist worker gets ``cpus // N`` threads (at least
one); a run without xdist keeps every CPU. Without this each worker's torch
opens one thread per CPU, and six workers on eight CPUs run 48 threads that
mostly wait on each other.

The Python processes that tests start inherit ``OMP_NUM_THREADS``, where it
sizes numpy's BLAS as well (in this process a pytest plugin has loaded numpy
already). XLA's own pool is left as it is: the JAX reference's results are
what the goldens hold.
"""
import os

share = max(1, len(os.sched_getaffinity(0))
            // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
os.environ["OMP_NUM_THREADS"] = str(share)
