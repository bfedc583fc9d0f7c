#!/usr/bin/env python3
"""The benchmark of zdcsim_torch, one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. ``BENCHMARK.json`` names the cells, configurations and metrics; the
files under ``benchmark/`` hold each piece (``harness/spec.py``). The last
line of standard output is the result; a run without the cards, or in a
checkout without the program, exits non-zero and prints none.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# caches of the libraries the program uses, at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(var, os.path.join(ROOT, ".bench_cache", sub))
sys.path[:0] = [HERE, ROOT]

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T_START))
