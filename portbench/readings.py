"""The readings that a cell's limits are set from, in one process: the
program's, the control's and each fault's, every one against the plain
reference on the same seed.

    python portbench/readings.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--device cuda|cpu]

For each seed the cell's entry is set up and warmed as a run sets it up.
Lower readings (``--seeds``): one timed-path run compared with the
reference, every number of the cell's comparison.  Upper readings
(``--control-seeds``): the entry's `control` (the reference in the
precision below the configuration's, in the program's place) compared the
same way.  Fault readings (``--fault-seeds``): each of the entry module's
`FAULTS`, where it has them, the timed path run again with the program
broken underneath.  One JSON line per seed, then one line with the largest
lower reading, the smallest upper reading and each fault's smallest
reading of each number.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _fold(into: dict, nums: dict, pick) -> None:
    for k, v in nums.items():
        into[k] = pick(into.get(k, v), v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    cell = harness.cell_spec(args.workload)
    faults = getattr(importlib.import_module(
        f"portbench.entries.{cell['params']['entry']}"), "FAULTS", {})
    lower, upper = {}, {}
    by_fault = {name: {} for name in faults}
    for seed in sorted({*args.seeds, *args.control_seeds,
                        *args.fault_seeds}):
        t0 = time.perf_counter()
        entry = harness.make_entry(cell, seed, args.device)
        entry.setup()
        entry.run()
        res = entry.run()
        idx = entry.sample()
        ref = entry.reference(idx)
        line = {"seed": seed}
        if seed in args.seeds:
            line["program"] = entry.compare(entry.answers(res, idx), ref)
            _fold(lower, line["program"], max)
        if seed in args.control_seeds:
            line["control"] = entry.compare(entry.control(idx), ref)
            _fold(upper, line["control"], min)
        if seed in args.fault_seeds:
            for name, fault in faults.items():
                with fault():
                    got = entry.answers(entry.run(), idx)
                line[name] = entry.compare(got, ref)
                _fold(by_fault[name], line[name], min)
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del entry, res, ref
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "faults": by_fault}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
