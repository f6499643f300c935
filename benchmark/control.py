"""The control and the lower readings behind each limit of ``correct``.

    python3 -m benchmark.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a short window at the
cell's own sizes, then the compared numbers read twice on the checked
image: of the program (a lower reading) and of the control, the plain
reference computed one precision step below what the configuration states
(fp8 for bf16, int4 for int8, TF32 for f32), in the program's place (an
upper reading). Prints one JSON line per seed.
``benchmark/tests/test_bench_run.py`` runs it on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

from benchmark import run


def readings(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """{"program": numbers, "control": numbers, "control_correct": the
    control judged by the limits as ``correct`` judges the program} of one
    seed."""
    from benchmark import harness

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = harness.run_cell(cell, seed, seconds, False, device=device, control=True)
    if rc != 0:
        raise RuntimeError(f"{cell.name} seed {seed}: the run exited with {rc}")
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    return {"seed": seed, "correct": result["correct"],
            "program": {k: v["value"] for k, v in result["checks"].items()},
            "control": result["control"], "control_correct": result["control_correct"],
            "metrics": result["metrics"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    run.environment()
    from benchmark import manifest

    cell = manifest.Cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(dict(readings(cell, seed, args.seconds), workload=args.workload)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
