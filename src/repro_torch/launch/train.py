"""End-to-end training driver.

Port of `repro.launch.train` for every family (dense and MoE decoders,
the zamba hybrid and xLSTM on their tokens alone, the VLM, whose batch
gains zero patch embeddings, and the encoder-decoder, whose batch gains
frames of 0.02, as the reference's): the deterministic token stream,
AdamW with a warmup+cosine schedule, optional gradient compression and
accumulation, atomic checkpoints (`repro_torch.checkpoint.Checkpointer`: a
background save every ``--ckpt-every`` steps and a blocking one at the
end), straggler detection and restart from the newest checkpoint
(``--resume``).  Runs on CUDA unless given ``--device``, in float32
activations as the reference's launcher does:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2-0.5b --reduced --steps 100 --batch 4 --seq 32

Unlike the reference, which prints ``(now - t_last)`` after setting
``t_last = now`` (always 0 ms), the log line prints the step's real
interval (ROADMAP C2).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import RunConfig, ShapeConfig, get_config, reduced
from ..data import DataConfig, TokenStream
from ..device import resolve_device
from ..models.common import tree_leaves
from ..optim import AdamW, warmup_cosine
from ..runtime.fault import StragglerDetector
from ..runtime.step import init_train_state, make_train_step


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("custom", args.seq, args.batch, "train")
    rcfg = RunConfig(model=cfg, shape=shape, fsdp=args.fsdp,
                     remat=args.remat, activ_dtype="float32",
                     grad_accum=args.grad_accum,
                     grad_compression=args.compression)
    return cfg, rcfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8_ef", "topk_ef"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="simulate a failure at this step (fault-tol demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, rcfg = build(args)
    opt = AdamW(lr=warmup_cosine(args.lr, warmup=20, total=args.steps))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state, _ = init_train_state(rcfg, gen, device=dev, optimizer=opt)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M device={dev}")

    step_fn = make_train_step(rcfg, optimizer=opt)
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state, into=state)
        start = int(state.step)
        print(f"resumed from step {start}")

    det = StragglerDetector(["host0"])
    losses = []
    t_last = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step).items()}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (args.batch, cfg.n_patches, cfg.d_model), device=dev)
        if cfg.family == "encdec":
            batch = {"tokens": batch["tokens"],
                     "frames": torch.ones((args.batch, args.seq,
                                           cfg.d_model), device=dev) * 0.02}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        now = time.time()
        dt, t_last = now - t_last, now
        det.record("host0", dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({dt * 1e3:.0f}ms)", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(int(state.step), state, blocking=False)
        if args.crash_at == step:
            ckpt and ckpt.wait()
            raise SystemExit(f"simulated crash at step {step}")
    if ckpt:
        ckpt.save(int(state.step), state, blocking=True)
    print(f"final loss {np.mean(losses[-10:]):.4f} "
          f"(first10 {np.mean(losses[:10]):.4f})")
    return losses


if __name__ == "__main__":
    main()
