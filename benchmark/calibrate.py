#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, in one
process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --controls int4 --seconds <s> \\
        [--faults scaled_tile,... --fault-seeds 4,5,6]

Each seed is a whole run of the cell (its result line printed as the
benchmark prints it); on each control seed the check is made again with
each of ``--controls`` in the program's place: the control of the next
lower precision (``int4`` for the serving cells, ``tf32`` for the float32
step) or a fault (``half_batch``, ``unchanged``; see the entry's
``check``). On each fault seed a serving cell runs again whole with each
of ``--faults`` (``harness/faults.py``) planted in the program's bulk call.
Every number the entry's check computes is read, compared by the cell or
not. The last line: ``{"program": {number: [readings]}, "<control or
fault>": {number: [readings]}, ...}``; a limit lies above the program's
largest reading and below the control's smallest.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.runner import execute  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", default="int4")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args()
    readings = {"program": {}}
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.fault_seeds.split(",") if s):
        for fault in (f for f in args.faults.split(",") if f):
            from harness.faults import FAULTS, plant
            from harness.spec import Spec

            mend = plant(FAULTS[fault], int(Spec().cell(args.workload)["tile"]))
            try:
                run = execute(["--workload", args.workload, "--seed", str(seed), "--seconds",
                               str(args.seconds)], t_start=time.perf_counter())
            finally:
                mend()
            for name, value in run.extra["numbers"].items():
                readings.setdefault(fault, {}).setdefault(name, []).append(value)
            print(json.dumps({"seed": seed, fault: run.extra["numbers"],
                              "correct": run.correct}), flush=True)
            del run
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = execute(["--workload", args.workload, "--seed", str(seed), "--seconds",
                       str(args.seconds)], t_start=t)
        for name, value in run.extra["numbers"].items():
            readings["program"].setdefault(name, []).append(value)
        entry = run.spec.module("entries", run.cell["entry"])
        for control in (args.controls.split(",") if seed in control_seeds else []):
            entry.check(run, *run.extra["check_inputs"], control=control)
            for name, value in run.extra["numbers"].items():
                readings.setdefault(control, {}).setdefault(name, []).append(value)
            print(json.dumps({"seed": seed, control: run.extra["numbers"]}), flush=True)
        del run
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
