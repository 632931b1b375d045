"""The readings that a cell's limit is set from: per seed, the program's
gaps and its control's, each judged at the cell's limits.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 25

Each seed is one run of the cell (``run.run_cell``) in this process, the
kernels built once: the program's served tokens are judged as in a
benchmark run, and on the same sample the control (the reference in the
precision below the configuration's) puts its own first tokens, whose
gaps are read too (``bench/compare.py``: the widest and the mean gap of
each). The control's gaps are then put in the program's place and held to
the cell's own limits (``bench/checks/<cell>.json``) by the same
comparison: ``control_correct`` has to be false. One JSON line a seed; the
command exits 1 if the control came out correct on any seed. Benchmark
runs never run this.
"""

from __future__ import annotations

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
# as in run.py: this folder's modules must not shadow the standard library's
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path[:0] = [os.path.dirname(_HERE), os.path.join(os.path.dirname(_HERE), "src")]

import argparse  # noqa: E402
import json  # noqa: E402

from bench.run import ROOT, run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from bench import compare
    from bench.cell import resolve
    from bench.model import program_config
    from bench.reference.precision import control

    cell = resolve(args.workload, ROOT)
    prec = control(program_config(cell.config)[1]["dtype"])
    if not torch.cuda.is_available():
        print("control readings are taken on the card", file=sys.stderr)
        return 3
    control_passed = False
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, seed, args.seconds, False, control=prec)
        ctrl = compare.control_checks(out["readings"], cell.checks["limits"])
        control_passed |= compare.passed(ctrl)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": prec,
                          "correct": out["correct"], "control_correct": compare.passed(ctrl),
                          "readings": out["readings"], "checks": out["checks"],
                          "control_checks": ctrl, "metrics": out["metrics"]}), flush=True)
    return 1 if control_passed else 0


if __name__ == "__main__":
    sys.exit(main())
