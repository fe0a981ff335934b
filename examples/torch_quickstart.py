"""Quickstart through the PyTorch port: the paper in a minute, on the card.

Builds the paper's 4x4 grid instance, computes the Theorem-4 capacity bound
via the multicommodity LP, runs the pi3 backpressure policy below and above
the bound through the port's trace simulator (one captured CUDA graph on
the card), and prints the observed throughput and stability.  It checks
what it prints: below the bound the backlog stays bounded, above it the
backlog grows, and no run delivers more than the bound.

  python examples/torch_quickstart.py                # the card
  python examples/torch_quickstart.py --device cpu
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (PolicyConfig, capacity_upper_bound,  # noqa: E402
                              paper_grid_problem)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.sim import simulate  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
ap.add_argument("--T", type=int, default=3000, help="slots per run")
args = ap.parse_args()
device = resolve_device(args.device)

problem = paper_grid_problem(C=2.0)           # 4x4 grid, R=5, four C=2 nodes
lam_star = capacity_upper_bound(problem).lam_star
print(f"Theorem-4 LP capacity: lambda* = {lam_star:.2f} queries/slot "
      f"(device {device})")

grows = {}
for lam in (0.75 * lam_star, 1.25 * lam_star):
    res = simulate(problem, PolicyConfig(name="pi3", eps_b=0.01),
                   lam=lam, T=args.T, seed=0, device=device)
    rate = float(res.useful_rate(args.T // 3))
    q = res.total_queue.cpu().numpy()
    growth = (q[-1] - q[len(q) // 2]) / (len(q) // 2)   # backlog slope/slot
    grows[lam] = growth > 0.3
    print(f"  lambda={lam:4.1f}: delivered {rate:5.2f} results/slot, "
          f"backlog {'GROWS (unstable, as predicted)' if grows[lam] else 'bounded (stable)'}")
    assert rate <= lam_star * 1.02, (lam, rate)

assert grows == {0.75 * lam_star: False, 1.25 * lam_star: True}, grows
print("\npi3 = backpressure routing + join-shortest-sum-of-queues load"
      "\nbalancing + dummy-packet regulator (paper eq. 8-10).")
