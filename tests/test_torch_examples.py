"""The port's examples (`examples/torch_*.py`) run to their end on the CPU
at cut sizes, each passing its own check; on the card they run at the
originals' sizes (`chip_smoke.py`).  They and the paper-figure script
import neither jax nor the JAX package."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("script,args,expect", [
    ("torch_quickstart.py", ["--T", "800"], "GROWS (unstable"),
    ("torch_moe_backpressure.py", ["--steps", "10"], "router=backpressure"),
    ("torch_serve_backpressure.py", ["--T", "512"], "served 6 requests"),
    ("torch_train_lm.py", ["--steps", "30", "--crash-at", "19",
                           "--ckpt-every", "10"], "OK: resumed training"),
])
def test_example_runs_on_the_cpu(script, args, expect, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert expect in out.stdout


def test_examples_and_figures_import_neither_jax_nor_the_reference():
    files = sorted((ROOT / "examples").glob("torch_*.py"))
    files.append(ROOT / "scripts" / "torch_paper_figures.py")
    assert len(files) == 5
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path, n)
