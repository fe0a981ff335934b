"""The readings that a cell's limits are set from, in one process.

    python portbench/readings.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--device cuda|cpu]

Lower readings: for each of ``--seeds``, the program's timed path (the
cell's entry, after a warm run) compared with the plain reference, every
number of the cell's comparison.  Upper readings: for each of
``--control-seeds``, the control, the reference with its carry held in
bfloat16 in the program's place, compared the same way.  One JSON line per
reading, then one line with the largest lower and the smallest upper
reading of each number.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    cell = harness.cell_spec(args.workload)
    lower, upper = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        entry = harness.make_entry(cell, seed, args.device)
        entry.setup()
        entry.run()
        res = entry.run()
        idx = entry.sample()
        nums = entry.compare(entry.answers(res, idx), entry.reference(idx))
        for k, v in nums.items():
            lower[k] = max(lower.get(k, v), v)
        print(json.dumps({"reading": "program", "seed": seed, **nums,
                          "s": time.perf_counter() - t0}), flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        entry = harness.make_entry(cell, seed, args.device)
        idx = entry.sample()
        nums = entry.compare(entry.reference(idx, "bfloat16"),
                             entry.reference(idx))
        for k, v in nums.items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({"reading": "control", "seed": seed, **nums,
                          "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
