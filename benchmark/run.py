"""Run one benchmark cell of the PyTorch/CUDA port `dcfa_yolo_tpu_torch`:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
compared with the plain reference, each beside its limit.  See
benchmark/README.md."""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, for the port's package
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# keep libraries that can load JAX by themselves from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from benchlib.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t0=_T0))
