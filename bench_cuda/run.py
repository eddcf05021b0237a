"""Run one cell of the benchmark of ``upgdm_tpu_torch`` once, on the CUDA
devices of this machine:

    python3 bench_cuda/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``: each
number compared beside its limit, also the last lines of standard error).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window. ``--readings 1`` adds the control's
numbers (setting limits) and ``--fault <name>`` plants a fault of
``faults.py`` in the program (showing the comparison catches it); measured
runs use neither. Exits non-zero, printing no result, without the CUDA
devices the cell needs or if JAX or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from bench_cuda import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
