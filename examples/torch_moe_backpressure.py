"""Example through the PyTorch port: loss-free MoE load balancing via the
paper's virtual queues, on the card.

Trains two tiny granite-family MoE models on the same stream, one with the
backpressure router (H-queue selection bias, paper eq. 9/10), one with
plain top-k, and prints each one's per-expert load balance (the spread of
its H queues) after training.  It checks that the backpressure router
balances better than plain top-k.

  python examples/torch_moe_backpressure.py            # the card
  python examples/torch_moe_backpressure.py --device cpu
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import (RunConfig, ShapeConfig, get_config,  # noqa: E402
                                 reduced)
from repro_torch.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.runtime.step import init_train_state, make_train_step  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
ap.add_argument("--steps", type=int, default=40)
args = ap.parse_args()
device = resolve_device(args.device)
B, S = 8, 64

spread = {}
for router in ("plain", "backpressure"):
    cfg = dataclasses.replace(reduced(get_config("granite-moe-1b-a400m")),
                              router=router)
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("ex", S, B, "train"),
                     activ_dtype="float32", remat="none")
    gen = torch.Generator(device=device).manual_seed(0)
    state, _ = init_train_state(rcfg, gen, device=device)
    step = make_train_step(rcfg)
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
    for i in range(args.steps):
        state, metrics = step(state, {
            "tokens": torch.as_tensor(data.batch(i)["tokens"],
                                      device=device)})
    # H tracks cumulative overflow per expert; its spread measures imbalance
    H = state.router_H.cpu()
    loss = float(metrics["loss"])
    spread[router] = float(H.max() - H.min()) if H.numel() else 0.0
    print(f"router={router:13s} loss={loss:.3f} "
          f"H-spread={spread[router]:10.1f} (lower = better balanced)")

assert spread["backpressure"] < spread["plain"], spread
print("\nThe backpressure router keeps the virtual queues drained "
      "(bounded H) with no auxiliary loss term: the paper's H_n dynamics "
      "as loss-free expert balancing.")
