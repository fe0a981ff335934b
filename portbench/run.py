"""The port's benchmark: one run of one cell.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared with its limit (also
the last lines of standard error).  Without a CUDA card, outside a checkout
that holds the program, or with the JAX package loaded, it prints no
result and exits with another code than 0.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: Top-level module names that may not be loaded: the JAX package and JAX.
BARRED = ("jax", "jaxlib", "flax", "repro")


def barred_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BARRED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program here: {ROOT / 'src' / 'repro_torch'} is missing",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    os.environ.setdefault("USE_FLAX", "0")
    from portbench import harness
    cell = harness.cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t0=T0, cell=cell)
    found = barred_modules()
    if found:
        print(f"barred modules loaded: {found}", file=sys.stderr)
        return 4
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": out.metrics,
            "device": out.device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, v, lim in out.checks}
    for k, v, lim in out.checks:
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
