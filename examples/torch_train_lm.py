"""End-to-end example through the PyTorch port, on the card: train a
~1M-param OLMo-family model with the full substrate (data pipeline,
AdamW + cosine, checkpointing), then SIMULATE A CRASH and restart from the
checkpoint: the loss curve must continue where it left off and fall.

  python examples/torch_train_lm.py                  # the card
  python examples/torch_train_lm.py --device cpu
"""
import argparse
import pathlib
import shutil
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main as train  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--crash-at", type=int, default=119)
ap.add_argument("--ckpt-every", type=int, default=50)
args = ap.parse_args()

ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
common = ["--arch", "olmo-1b", "--reduced", "--batch", "8", "--seq", "64",
          "--ckpt-dir", ckpt_dir, "--ckpt-every", str(args.ckpt_every),
          "--log-every", "25", "--steps", str(args.steps)]
if args.device:
    common += ["--device", args.device]

try:
    print(f"=== phase 1: train, crash at {args.crash_at} ===")
    try:
        train(common + ["--crash-at", str(args.crash_at)])
    except SystemExit as e:
        print(f"(crashed as scripted: {e})")
    else:
        raise AssertionError("phase 1 did not crash")

    print(f"\n=== phase 2: restart from checkpoint, train to step "
          f"{args.steps} ===")
    losses = train(common + ["--resume"])
    assert losses[-1] < losses[0], "loss must decrease across the restart"
    print(f"\nOK: resumed training improved loss to {losses[-1]:.3f}")
finally:
    shutil.rmtree(ckpt_dir, ignore_errors=True)
