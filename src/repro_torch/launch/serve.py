"""LLM serving entry point: continuous batching over fixed decode slots, with
dummy-slot padding (the paper's regulator made literal — the decode step
has a static batch, so empty slots run as dummy packets and their outputs
are ignored).

Port of `repro.launch.serve`.  Runs on CUDA unless given a device:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch granite-moe-1b-a400m --requests 8 --slots 4 --max-new 12

As in the reference, ``--reduced`` is on by default and cannot be turned
off from the command line (`store_true` with ``default=True``), so the CLI
serves the reduced model; drive `Engine` directly for full width.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config, reduced
from ..device import resolve_device
from ..models import get_model, split_tree


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Continuous batching over fixed decode slots with dummy-slot padding.

    Drives any ported arch through the uniform ModelAPI: submit prompts;
    `step()` prefills newly admitted requests (one at a time, by decoding
    the prompt into the cache) and decodes one token for every active
    slot.  ``params`` must lie on ``device`` (CUDA unless given).
    ``steps`` counts the decode steps run, prefill steps included.
    """

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.api = get_model(cfg)
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.caches = self.api.init_decode(slots, max_len, torch.float32,
                                           device=self.device)
        self.router_H = self.api.init_state(device=self.device).router_H
        self.slot_req: List[Optional[ServeRequest]] = [None] * slots
        self.pending: List[ServeRequest] = []
        self.finished: Dict[int, ServeRequest] = {}
        self._last_tok = np.zeros((slots,), np.int64)
        self.steps = 0

    def _step(self, tokens: np.ndarray) -> torch.Tensor:
        logits, self.caches = self.api.decode_step(
            self.params, self.caches,
            {"tokens": torch.as_tensor(tokens, device=self.device)},
            activ_dtype=torch.float32, router_H=self.router_H)
        self.steps += 1
        return logits

    # ------------------------------------------------------------------

    def submit(self, prompt: List[int], max_new: int = 16) -> int:
        rid = len(self.finished) + len(self.pending) + sum(
            r is not None for r in self.slot_req)
        self.pending.append(ServeRequest(rid, list(prompt), max_new))
        return rid

    def _admit(self):
        for s in range(self.slots):
            if self.slot_req[s] is None and self.pending:
                req = self.pending.pop(0)
                self.slot_req[s] = req
                # prefill by decoding the prompt into this slot's cache:
                # tokens of OTHER slots are dummy packets (last token echo).
                for tok in req.prompt[:-1]:
                    toks = self._last_tok.copy()
                    toks[s] = tok
                    self._step(toks)
                    self._last_tok = toks
                self._last_tok[s] = req.prompt[-1]

    def step(self) -> int:
        """One decode tick over all slots; returns #active real slots."""
        self._admit()
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        logits = self._step(self._last_tok)
        if self.temperature > 0:
            probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                                  dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)      # first occurrence on ties
        nxt = nxt.cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            req.out.append(int(nxt[s]))
            self._last_tok[s] = nxt[s]
            if len(req.out) >= req.max_new:
                req.done = True
                self.finished[req.rid] = req
                self.slot_req[s] = None
        return len(active)

    def run_until_done(self, max_ticks: int = 10_000) -> Dict[int, ServeRequest]:
        for _ in range(max_ticks):
            if not self.pending and all(r is None for r in self.slot_req):
                break
            self.step()
        return self.finished


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    api = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params, _ = split_tree(api.init(gen))
    eng = Engine(cfg, params, slots=args.slots, max_len=args.max_len,
                 device=dev)

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 16))
        eng.submit(list(rng.integers(0, cfg.vocab, plen)), args.max_new)

    t0 = time.time()
    finished = eng.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in finished.values())
    print(f"served {len(finished)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s on {dev})")
    for rid in sorted(finished)[:4]:
        print(f"  req {rid}: out={finished[rid].out[:8]}...")
    if len(finished) != args.requests:
        raise RuntimeError(f"finished {len(finished)} of {args.requests} "
                           f"requests")
    return finished


if __name__ == "__main__":
    main()
