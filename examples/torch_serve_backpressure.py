"""Example through the PyTorch port: the serving subsystem on the card.

Live query traffic through backpressure admission control, scored against
the exact LP bound, then the continuous-batching LLM engine (dummy-slot
padding: the paper's regulator made literal).  It checks that no load
delivers more than the bound, that overload sheds no less than the light
load, and that the engine finishes every request.

  python examples/torch_serve_backpressure.py           # the card
  python examples/torch_serve_backpressure.py --device cpu
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fleet import policy_bound_exact  # noqa: E402
from repro_torch.serving import ServingJob, run_serving  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
ap.add_argument("--T", type=int, default=2048, help="serving slots")
args = ap.parse_args()
device = resolve_device(args.device)

# --- control plane: bursty queries vs the admission gate -------------------
bound = policy_bound_exact("paper_grid", "pi3_reg", 0.05)
print(f"paper grid, pi3_reg, eps_B=0.05: exact LP bound = {bound:.1f} QPS")

jobs = [ServingJob(trace="bursty", lam=frac * bound, seed=0)
        for frac in (0.6, 0.95, 1.3)]
res = run_serving(jobs, T=args.T, chunk=min(256, args.T), device=device)
print("markov_onoff bursts at three offered loads:")
for job, m in zip(jobs, res.metrics):
    print(f"  lam={job.lam:5.2f} ({job.lam / bound:4.2f}x bound): "
          f"delivered={m['delivered_qps']:5.2f} QPS "
          f"shed={m['shed_frac']:4.2f} p99={m['p99_sojourn']:6.0f} slots "
          f"gate_open={m['gate_open_frac']:4.2f}")
    assert m["delivered_qps"] <= 1.02 * bound, (job.lam, m["delivered_qps"])
# 0.6x/0.95x: everything admitted; 1.3x: the gate duty-cycles, shedding
# the excess while the admitted rate holds at capacity.  (The bursts'
# ON phases overload even the 0.6x load at times: the gate sheds there
# too, as the reference's does.)
assert res.metrics[2]["shed_frac"] >= res.metrics[0]["shed_frac"], \
    [m["shed_frac"] for m in res.metrics]

# --- data plane: actual batched decode with padding slots ------------------
print("\nbatched decode engine (qwen2-family reduced config):")
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.serve import Engine  # noqa: E402
from repro_torch.models import get_model, split_tree  # noqa: E402

cfg = reduced(get_config("qwen2-0.5b"))
api = get_model(cfg)
params, _ = split_tree(api.init(torch.Generator(device=device).manual_seed(0)))
eng = Engine(cfg, params, slots=4, max_len=64, device=device)
rng = np.random.default_rng(0)
for _ in range(6):
    eng.submit(list(rng.integers(0, cfg.vocab, rng.integers(3, 9))),
               max_new=8)
fin = eng.run_until_done()
print(f"  served {len(fin)} requests; sample outputs:")
for rid in sorted(fin)[:3]:
    print(f"    req {rid}: {fin[rid].out}")
assert len(fin) == 6 and all(len(r.out) == 8 for r in fin.values())
