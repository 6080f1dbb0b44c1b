"""Summarise an A/B of two training runs (port of ``scripts/ab_report.py``:
the same flags, table and ``AB_RECIPE.json`` summary).

Reads the two runs' ``metrics.jsonl`` (``train/trainer.py`` writes the
``val/mAP50`` and ``val/mAP50-95`` keys), prints a side-by-side epoch table
(every Nth epoch and each run's last) and the summary, and writes the
summary to ``--out``. Host only.

    python -m yolo_scratch_tpu_torch.ab_report [--a runs/ab_noaug] [--b runs/ab_recipe]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def load(run_dir):
    rows = []
    with open(Path(run_dir) / "metrics.jsonl") as fh:
        for line in fh:
            rows.append(json.loads(line))
    return rows


def best(rows, key="val/mAP50"):
    i = max(range(len(rows)), key=lambda j: rows[j].get(key, 0.0))
    return i, rows[i]


def side(run, rows) -> dict:
    """One run's headline: each metric's best (at its own best epoch) and
    final values."""
    i50, r50 = best(rows, "val/mAP50")
    i95, r95 = best(rows, "val/mAP50-95")
    return {
        "run": run, "epochs": len(rows),
        "best_mAP50": r50.get("val/mAP50"),
        "best_mAP50_epoch": i50 + 1,
        "best_mAP50_95": r95.get("val/mAP50-95"),
        "best_mAP50_95_epoch": i95 + 1,
        "final_mAP50": rows[-1].get("val/mAP50"),
        "final_mAP50_95": rows[-1].get("val/mAP50-95"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="A/B summary of two runs' metrics.jsonl")
    ap.add_argument("--a", default="runs/ab_noaug", help="baseline (no aug)")
    ap.add_argument("--b", default="runs/ab_recipe", help="full recipe")
    ap.add_argument("--out", default="AB_RECIPE.json")
    ap.add_argument("--every", type=int, default=10)
    args = ap.parse_args(argv)

    ra, rb = load(args.a), load(args.b)
    print(f"{'epoch':>5s} | {'noaug mAP50':>11s} {'recipe mAP50':>12s} | "
          f"{'noaug 50-95':>11s} {'recipe 50-95':>12s}")
    for e in range(0, max(len(ra), len(rb))):
        if e % args.every and e != len(ra) - 1 and e != len(rb) - 1:
            continue
        a = ra[e] if e < len(ra) else {}
        b = rb[e] if e < len(rb) else {}
        print(f"{e + 1:5d} | {a.get('val/mAP50', float('nan')):11.4f} "
              f"{b.get('val/mAP50', float('nan')):12.4f} | "
              f"{a.get('val/mAP50-95', float('nan')):11.4f} "
              f"{b.get('val/mAP50-95', float('nan')):12.4f}")

    summary = {"baseline": side(args.a, ra), "recipe": side(args.b, rb)}
    for key in ("best_mAP50", "best_mAP50_95", "final_mAP50", "final_mAP50_95"):
        summary[f"delta_{key}"] = round(
            summary["recipe"][key] - summary["baseline"][key], 4)
    Path(args.out).write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
