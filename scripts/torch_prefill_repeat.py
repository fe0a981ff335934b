#!/usr/bin/env python3
"""Run-to-run repeatability of the port's prefill path, card and CPU.

Run from the root of a checkout on a machine with one CUDA card, once per
process to compare (each process dumps its first runs; ``--against`` reads
an earlier process's dump):

    python3 scripts/torch_prefill_repeat.py --dump build/repeat/a.pt
    python3 scripts/torch_prefill_repeat.py --dump build/repeat/b.pt \\
        --against build/repeat/a.pt
    MKL_CBWR=AVX2 python3 scripts/torch_prefill_repeat.py \\
        --dump build/repeat/c.pt --against build/repeat/a.pt

It builds the inputs of `chip_smoke.phase_prefill_reference`
(granite-moe-1b-a400m at full width and 4 layers, weights from seed 2;
B=2, S=256 tokens from seed 3; float32 activations), runs the free-running
forward `ModelAPI.logits` twice on the card, twice on the CPU and once more
on the CPU with one thread, records each routing call's inputs (hidden
states and router queues) and picks, and prints:

- the host: CPU model and vector extensions, torch's threads and BLAS, and
  MKL_CBWR when set (MKL picks its code path, and with it the order of
  its float32 sums, from the CPU it finds unless MKL_CBWR fixes one);
- each side's runs in this process against each other, bit for bit, with
  the first layer whose router inputs differ;
- the card against the CPU, per layer: the largest difference of a gate
  selection score, the tokens whose picks differ with their margins, and
  the smallest margins in the data (the near-ties a small change can flip);
- with ``--against``, each side against the same side of the earlier
  process, bit for bit.

The dumps hold every routing call's hidden states (8 MiB a side): keep
them in a git-ignored directory such as ``build/``.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def host_info(cs) -> dict:
    import torch
    config = torch.__config__.show()
    blas = [ln.strip("- ") for ln in config.splitlines()
            if "Math Kernel" in ln] + re.findall(r"BLAS_INFO=\w+", config)
    return {"cpu": cs.host_cpu(), "threads": torch.get_num_threads(),
            "blas": blas, "MKL_CBWR": os.environ.get("MKL_CBWR")}


def run_logits(api, params, toks, dev, moe):
    """One free-running forward: its logits and, per routing call, (picks,
    hidden states, router weights, router queues), all moved to the CPU."""
    import torch
    calls = []
    original = moe._route

    def recording_route(cfg_, p, x_flat, rs, *, use_kernel=False):
        out = original(cfg_, p, x_flat, rs, use_kernel=use_kernel)
        calls.append((out[0], x_flat, p["router"], rs.H))
        return out

    moe._route = recording_route
    try:
        with torch.inference_mode():
            logits, _, _ = api.logits(
                params, {"tokens": torch.as_tensor(toks, device=dev)},
                activ_dtype=torch.float32,
                router_H=api.init_state(device=dev).router_H)
    finally:
        moe._route = original
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"logits": logits.cpu(),
            "calls": [tuple(t.detach().cpu() for t in c) for c in calls]}


def same_bits(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def diff(a: dict, b: dict) -> str:
    """'bit-identical', or where two runs of one side first part."""
    for i, (ca, cb) in enumerate(zip(a["calls"], b["calls"])):
        for name, j in (("hidden states", 1), ("router queues", 3),
                        ("picks", 0)):
            if not same_bits(ca[j], cb[j]):
                d = float((ca[j].double() - cb[j].double()).abs().max())
                return f"layer {i}: {name} differ (max abs {d:.3e})"
    if not same_bits(a["logits"], b["logits"]):
        return "logits differ"
    return "bit-identical"


def margins(sel, k):
    """Per token, the smallest gap between adjacent selection scores among
    its top k + 1."""
    import torch
    top = torch.sort(sel, -1, descending=True).values[:, :k + 1]
    return (top[:, :-1] - top[:, 1:]).min(-1).values


def card_vs_cpu(card: dict, cpu: dict, cfg, cs) -> list:
    out = []
    for i, (a, b) in enumerate(zip(card["calls"], cpu["calls"])):
        rows, m, delta, ok = cs.compare_routes(a, b, cfg)
        _, sel = cs.recorded_sel(b, cfg)
        near = margins(sel, cfg.top_k)
        low = near.argsort()[:3]
        out.append(f"layer {i}: sel differs by at most {delta:.3e}; "
                   f"{len(rows)} tokens pick other experts "
                   f"{[(int(r), float(x)) for r, x in zip(rows, m)]}"
                   f"{' (near-ties)' if len(rows) and ok else ''}; "
                   f"smallest margins in the data (token, margin) "
                   f"{[(int(r), float(near[r])) for r in low]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", required=True,
                    help="where to save this process's first runs")
    ap.add_argument("--against", action="append", default=[],
                    help="an earlier process's dump to compare with")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_prefill_repeat: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.models import get_model, moe
    _build.build_all()
    print(f"host: {host_info(cs)}; card: {cs.card_line()}", flush=True)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg, params = cs.serve_model(dev, n_layers=cs.REF_LAYERS, seed=2)
    params_cpu = cs.to_device_tree(params, cpu)
    api = get_model(cfg)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (cs.PREFILL_REF_B, cs.PREFILL_REF_S))
    card = [run_logits(api, params, toks, dev, moe) for _ in range(2)]
    host = [run_logits(api, params_cpu, toks, cpu, moe) for _ in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    host1 = run_logits(api, params_cpu, toks, cpu, moe)
    torch.set_num_threads(threads)
    print(f"in this process: card run 2 vs run 1: {diff(card[1], card[0])};"
          f" CPU run 2 vs run 1: {diff(host[1], host[0])}; CPU with 1 "
          f"thread vs {threads}: {diff(host1, host[0])}", flush=True)
    for line in card_vs_cpu(card[0], host[0], cfg, cs):
        print(f"card vs CPU, {line}", flush=True)
    dump = {"host": host_info(cs), "card": card[0], "cpu": host[0]}
    for path in args.against:
        other = torch.load(path)
        print(f"against {path} ({other['host']}): card "
              f"{diff(card[0], other['card'])}; CPU "
              f"{diff(host[0], other['cpu'])}", flush=True)
    pathlib.Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
    torch.save(dump, args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
