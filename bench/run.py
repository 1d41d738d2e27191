"""Run one cell of the port's benchmark and print its result line.

    python3 bench/run.py --workload zamba2-1.2b.train-8k --seed 7 --seconds 40 --trace 0

Run from the root of a checkout that holds ``src/repro_torch``, on a
machine with the GPUs the cell asks for.  The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, and with ``--trace 1`` ``breakdown``); the numbers compared
for ``correct`` end standard error.  Without a GPU, or without the
program, it prints no result and exits non-zero.
"""

import os
import pathlib
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]

# Kernel and compiler caches at fixed places inside the checkout, set
# before torch is imported: only the first run in a checkout builds.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench" / "torch_extensions")
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
os.environ["USE_FLAX"] = "0"

sys.path = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "bench"]

from bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_process=T0))
