"""CPU tests of the benchmark harness.  They import the harness from
`benchmark/` and the port from the checkout's root, never JAX."""

import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tests run in several worker processes: a few threads each
torch.set_num_threads(2)
