#!/usr/bin/env python3
"""Time variants of the CUDA-core flash kernel side by side on one card.

Builds `src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`
as committed and patched copies of it (`VARIANTS`: each a list of exact
text replacements, so a variant that no longer applies fails loudly),
plus any other source with the same C entry given as NAME=PATH (for
example the parent commit's kernel, unpacked under a git-ignored
directory).  For each: ptxas's registers and spill stores per
instantiation, CTAs per SM where the source reports them, a check
against the plain version (float32 within 1e-5, bfloat16 within 2e-2,
two calls bit-identical), then the time of one call at the float32
prefill shape (B=1, H=16, KH=8, S=32,768, D=64, causal) and the training
shape (B=8, S=512), taken in turns (every variant, then again in reverse
order) with CUDA events around back-to-back calls, beside SDPA's float32
memory-efficient kernel on the same inputs (kv heads repeated).

On a machine with a CUDA card, from the root of a checkout:

    python3 scripts/torch_flash_variants.py [NAME=PATH ...]

Prints one line per build, check and timing, then all the numbers as
one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"

#: Patches of the committed source: (old text, new text) pairs.
VARIANTS = {
    # the query block as the grid's fastest axis: longest first only
    # within each (head group, batch row)
    "x_fastest": [
        ("const int q0 = (gridDim.z - 1 - blockIdx.z) * p.BQ;",
         "const int q0 = (gridDim.x - 1 - blockIdx.x) * p.BQ;"),
        ("const int h0 = blockIdx.x * p.GC;", "const int h0 = blockIdx.y * p.GC;"),
        ("const int b = blockIdx.y;", "const int b = blockIdx.z;"),
        ("dim3 grid(H / p.GC, B, (p.S + p.BQ - 1) / p.BQ);",
         "dim3 grid((p.S + p.BQ - 1) / p.BQ, H / p.GC, B);")],
    # the K/V copy loop left to the compiler's unrolling
    "copy_unrolled": [
        ("#pragma unroll 1\n  for (int i = threadIdx.x; i < BK * CPR; i += NT) {",
         "  for (int i = threadIdx.x; i < BK * CPR; i += NT) {")],
    # no register cap: one CTA an SM at D <= 64
    "one_cta": [("D <= 64 ? 2 : 1", "1")],
    # a third K/V stage
    "stage3": [("constexpr int NSTAGE = 2;", "constexpr int NSTAGE = 3;")],
    # 8 rows a lane (S 8 x 4, P V 8 x D/8) in 128-thread CTAs, head groups
    # of at most 4 (a warp's 32 rows stay in one head)
    "rows8": [
        ("constexpr int NT = 256;", "constexpr int NT = 128;"),
        ("constexpr int RT = 4;", "constexpr int RT = 8;"),
        ("while (gc < 8 && G % (2 * gc) == 0)", "while (gc < 4 && G % (2 * gc) == 0)")],
}
PREFILL = (1, 16, 8, 32_768, 64)
TRAIN = (8, 16, 8, 512, 64)
CHECKS = [  # (B, H, KH, S, T, D, causal, window, dtype)
    (8, 16, 8, 512, 512, 64, True, None, "float32"),
    (1, 16, 8, 777, 777, 64, True, 100, "float32"),
    (2, 4, 2, 100, 333, 64, False, None, "float32"),
    (1, 16, 4, 300, 300, 64, True, None, "float32"),
    (1, 14, 2, 150, 150, 64, True, None, "float32"),
    (1, 8, 4, 400, 400, 128, True, 77, "float32"),
    (2, 16, 2, 200, 200, 32, True, None, "float32"),
    (1, 4, 2, 300, 300, 16, True, 40, "float32"),
    (1, 4, 2, 200, 200, 16, True, 50, "bfloat16"),
    (1, 8, 2, 333, 333, 32, False, None, "bfloat16")]


def patched(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"variant patch no longer applies: {old!r}")
        text = text.replace(old, new)
    return text


def build(name: str, text: str, workdir: pathlib.Path, nvcc: str, flags):
    cu, so = workdir / f"{name}.cu", workdir / f"{name}.so"
    cu.write_text(text)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    info = dict(build_s=time.perf_counter() - t0,
                registers=[int(x) for x in re.findall(r"Used (\d+) registers", log)],
                spill_stores=[int(x) for x in re.findall(r"(\d+) bytes spill stores", log)])
    if proc.returncode:
        print(f"{name}: nvcc failed\n{log[-4000:]}", flush=True)
        return name, None, info
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
        ctypes.POINTER(ctypes.c_longlong), ci, ci, ctypes.c_float, vp]
    lib.flash_attention_fwd.restype = ci
    return name, lib, info


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if not torch.cuda.is_available():
        print("torch_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    base = SOURCE.read_text()
    sources = {"committed": base}
    sources.update({k: patched(base, v) for k, v in VARIANTS.items()})
    for arg in sys.argv[1:]:
        name, path = arg.split("=", 1)
        sources[name] = pathlib.Path(path).read_text()
    nvcc, flags = _build.nvcc(), _build.NVCC_FLAGS
    result = {"card": card, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda kv: build(*kv, pathlib.Path(tmp), nvcc,
                                               flags), sources.items()))
    libs = {}
    for name, lib, info in built:
        result["variants"][name] = info
        print(f"build {name}: {info['build_s']:.1f} s, registers "
              f"{info['registers']}, spill stores {info['spill_stores']}",
              flush=True)
        if lib is not None:
            libs[name] = lib

    def call(lib, q, k, v, causal=True, window=None):
        B, H, S, D = q.shape
        KH, T = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        strides = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, out) for s in t.stride()[:3]))
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if q.dtype == torch.float32 else 1, B, H, KH, S, T, D, strides,
            int(causal), -1 if window is None else window, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch error {err}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for name, lib in list(libs.items()):
        info, worst, fails = result["variants"][name], 0.0, []
        for B, H, KH, S, T, D, causal, window, dt in CHECKS:
            dtype = getattr(torch, dt)
            q, k, v = (rnd((B, H, S, D), dtype), rnd((B, KH, T, D), dtype),
                       rnd((B, KH, T, D), dtype))
            try:
                out = call(lib, q, k, v, causal, window)
            except RuntimeError as e:       # e.g. too much shared memory
                fails.append(f"D={D} {dt}: {e}")
                continue
            again = call(lib, q, k, v, causal, window)
            ref = flash_attention_ref(q, k, v, causal=causal, window=window)
            tol = 1e-5 if dt == "float32" else 2e-2
            err = (out.float() - ref.float()).abs()
            worst = max(worst, float(err.max()))
            if not bool((err <= tol + tol * ref.float().abs()).all()) or \
                    not torch.equal(out, again):
                fails.append(f"{(B, H, KH, S, T, D, causal, window, dt)}: "
                             f"max abs {float(err.max()):.3e}")
        if hasattr(lib, "flash_attention_occupancy"):
            ctas = ctypes.c_int(0)
            lib.flash_attention_occupancy(0, 64, ctypes.byref(ctas))
            info["ctas_per_sm_f32_d64"] = ctas.value
        info.update(max_abs_err=worst, check_failures=fails)
        print(f"check {name}: max abs error {worst:.3e}; CTAs per SM (f32, "
              f"D=64) {info.get('ctas_per_sm_f32_d64', 'not reported')}; "
              f"failures {fails}", flush=True)

    def event_ms(fn, n, warm):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    shapes = {}
    for label, (B, H, KH, S, D), n in (("prefill", PREFILL, 3),
                                       ("train", TRAIN, 200)):
        q, k, v = rnd((B, H, S, D)), rnd((B, KH, S, D)), rnd((B, KH, S, D))
        shapes[label] = (q, k, v, n)
    order = list(libs)
    for turn in (order, order[::-1]):
        for name in turn:
            info = result["variants"][name]
            for label, (q, k, v, n) in shapes.items():
                ms = event_ms(lambda: call(libs[name], q, k, v), n, 2)
                info.setdefault(f"{label}_ms", []).append(ms)
            print(f"time {name}: prefill {info['prefill_ms'][-1]:.3f} ms, "
                  f"train {info['train_ms'][-1]:.4f} ms", flush=True)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        for label, (q, k, v, n) in shapes.items():
            G = q.shape[1] // k.shape[1]
            kr, vr = (t.repeat_interleave(G, dim=1) for t in (k, v))
            result[f"sdpa_f32_{label}_ms"] = event_ms(
                lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                       is_causal=True), n, 2)
    print(f"SDPA float32 (memory-efficient): prefill "
          f"{result['sdpa_f32_prefill_ms']:.3f} ms, train "
          f"{result['sdpa_f32_train_ms']:.4f} ms", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
