"""Run one cell of the benchmark once on this machine's GPU.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, the last
line of standard output; progress and the compared numbers with their
limits go to standard error. Exits non-zero, printing no result, without
the CUDA devices the cell asks for, or if JAX or the JAX package was
imported.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def environment():
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernels build into ``build/kernels``); no library loading
    JAX on its own."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    environment()
    from benchmark import harness, manifest

    cell = manifest.Cell(args.workload)
    return harness.run_cell(cell, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
