"""Roofline report: results/dryrun_torch/*.json -> markdown tables and
hillclimb target selection.

  PYTHONPATH=src python -m repro_torch.launch.report [--tag base] [--mesh local]

Port of `repro.launch.report`, reading the port's records
(`launch.dryrun`).  The roofline table and the targets need a traced
roofline: they skip the "layout" records of the logical meshes (single,
multi) and say so under the table.  A traced roofline is the plain
path's (a record's ``traced_path``), and the table and the targets say
so: its dominant term and bound upper-bound the card's kernel path and
are not the card's.  One device has no collectives, so the reference's
collective column and its "most collective-bound" target are left out.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def load(tag: str = "base"):
    recs = []
    for p in sorted(RESULTS.glob(f"*__{tag}.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}"
    return f"{x*1e3:.1f}m" if x >= 1e-3 else f"{x*1e6:.0f}u"


def _bound(rf) -> float:
    return max(rf["compute_s"], rf["memory_s"])


def roofline_table(recs, mesh: str = "local") -> str:
    rows = ["| arch | shape | chips | compute_s | memory_s | "
            "dominant | bound_s | 6ND/traced | peak_frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    n_layout = 0
    paths = set()
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "layout":
            n_layout += 1
        if r.get("status") != "ok":
            continue
        rf = r["roofline"]
        paths.add(r.get("traced_path"))
        bound = _bound(rf)
        peak_frac = rf["compute_s"] / bound if bound else 0.0
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['chips']} "
            f"| {fmt_s(rf['compute_s'])} | {fmt_s(rf['memory_s'])} "
            f"| {rf['dominant']} "
            f"| {fmt_s(bound)} "
            f"| {r['useful_flops_ratio'] and round(r['useful_flops_ratio'], 3)} "
            f"| {peak_frac:.3f} |")
    if "plain" in paths:
        rows.append("\nTraced on the plain path (naive [S, S] attention, "
                    "the kernels' plain versions, eager op-by-op bytes) at "
                    "the H100 peaks: dominant and bound_s upper-bound the "
                    "card's kernel path, they are not its bound.")
    if n_layout:
        rows.append(f"\n{n_layout} layout record(s) on the {mesh} mesh "
                    f"skipped: a logical mesh has no traced roofline.")
    return "\n".join(rows)


def dryrun_table(recs) -> str:
    rows = ["| arch | shape | mesh | chips | status | lower_s | "
            "temp_bytes/dev | arg_bytes/dev |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        mem = r.get("memory", {})
        tmp = mem.get("temp_size_in_bytes")
        arg = mem.get("argument_size_in_bytes")
        gb = lambda v: f"{v/2**30:.2f}G" if isinstance(v, int) else "-"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('chips','-')} "
            f"| {r['status']} | {r.get('lower_s','-')} | {gb(tmp)} | {gb(arg)} |")
    return "\n".join(rows)


def pick_hillclimb_targets(recs, mesh: str = "local") -> list:
    """worst peak-fraction and most paper-representative (the MoE arch
    whose router IS the paper's technique), among the traced records of
    ``mesh``.  The peak fraction is the traced path's (module
    docstring), and the reason says so."""
    ok = [r for r in recs if r.get("status") == "ok"
          and r.get("mesh") == mesh]
    # decode cells are inherently bandwidth-bound (peak_frac ~ 0 is not a
    # bug) — pick the worst *throughput* cell among train/prefill.
    heavy = [r for r in ok if r["shape"] in ("train_4k", "prefill_32k")]
    worst = max(heavy, key=lambda r: r["roofline"]["memory_s"])
    moe = [r for r in ok if r["arch"].startswith(("moonshot", "granite"))
           and r["shape"] == "train_4k"]
    rep = moe[0] if moe else ok[0]
    return [(worst["arch"], worst["shape"],
             f"worst peak fraction ({worst.get('traced_path')} path)"),
            (rep["arch"], rep["shape"], "paper technique (BP MoE router)")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="base")
    ap.add_argument("--mesh", default="local")
    ap.add_argument("--targets", action="store_true")
    args = ap.parse_args(argv)
    recs = load(args.tag)
    print(f"### Dry-run ({len(recs)} records, tag={args.tag})\n")
    print(dryrun_table(recs))
    print(f"\n### Roofline ({args.mesh} mesh, tag={args.tag})\n")
    print(roofline_table(recs, args.mesh))
    if args.targets:
        print("\n### Hillclimb targets\n")
        for a, s, why in pick_hillclimb_targets(recs, args.mesh):
            print(f"- {a} x {s} — {why}")


if __name__ == "__main__":
    main()
