"""Each test process runs on its share of the CPUs (the root conftest.py).

Under ``pytest -n N`` a worker gets ``cpus // N`` threads, at least one; a
run without xdist keeps every CPU. The Python processes that tests start
inherit the same count through ``OMP_NUM_THREADS``.
"""

import os
import subprocess
import sys

import pytest
import torch


def expected_share() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


@pytest.mark.parametrize("pool", ["torch", "omp_env"])
def test_worker_threads_are_its_share_of_the_cpus(pool):
    got = (torch.get_num_threads() if pool == "torch"
           else int(os.environ["OMP_NUM_THREADS"]))
    assert got == expected_share()


def test_child_python_inherits_the_share():
    r = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip()) == expected_share()
