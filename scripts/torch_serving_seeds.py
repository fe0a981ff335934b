#!/usr/bin/env python3
"""How does the admission gate's overload behaviour vary with the seed?

Runs `benchmarks/bench_serving.py`'s SERVING_SMOKE row at one rate
fraction (paper_grid, pi3_reg, bursty, T=4096, chunk=512, eps_b 0.05) on
``--seeds`` seeds through both packages on the CPU, each on its own noise
(JAX's threefry keys in the reference, the counter-based stream in the
port), and prints per seed the gate flips, the shed fraction and the
admitted rate, then the share of seeds at each flip count:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_serving_seeds.py \
        [--frac 1.3 --seeds 12]

The two noises agree in distribution only, so a committed row of two seeds
is compared by where it falls in these distributions, not bit for bit.
The port's CPU run costs about 2 s per seed at 12 seeds.
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frac", type=float, default=1.3)
    ap.add_argument("--seeds", type=int, default=12)
    args = ap.parse_args(argv)
    from repro import serving as js
    from repro.fleet import policy_bound_exact
    from repro_torch import serving as ts
    bound = policy_bound_exact("paper_grid", "pi3_reg", 0.05, 0)
    seeds = range(args.seeds)
    kw = dict(T=4096, chunk=512)
    runs = {
        "reference": js.run_serving(
            [js.ServingJob(trace="bursty", lam=args.frac * bound, seed=s)
             for s in seeds], **kw),
        "port": ts.run_serving(
            [ts.ServingJob(trace="bursty", lam=args.frac * bound, seed=s)
             for s in seeds], device="cpu", **kw),
    }
    for name, res in runs.items():
        flips = res.column("gate_flips")
        print(f"{name}: frac {args.frac}, bound {bound}, seeds 0-"
              f"{args.seeds - 1}")
        print(f"  flips {flips.astype(int).tolist()}")
        print(f"  shed {np.round(res.column('shed_frac'), 4).tolist()}")
        print(f"  admitted_rate "
              f"{np.round(res.column('admitted_rate'), 4).tolist()}")
        share = collections.Counter(flips.astype(int).tolist())
        print("  seeds by flips " + ", ".join(
            f"{k}: {v}/{len(flips)}" for k, v in sorted(share.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
