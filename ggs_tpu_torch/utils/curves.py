"""Loss-curve artifacts: matplotlib PNG + CSV (ggs_tpu/utils/curves.py).

Multi-curve plot with optional log-y, and a CSV with header
`gen,<curve>...`. Curves are host-side Python lists appended to once per
log block. Without matplotlib the PNG is skipped with a warning.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Sequence


def save_loss_curve_png(
    curves: Dict[str, Sequence[float]],
    out_path: str,
    title: str = "GA fitness over generations",
    xlabel: str = "Generation",
    ylabel: str = "MSE",
    log_y: bool = False,
    dpi: int = 144,
) -> None:
    if not out_path:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"[warn] matplotlib not available, cannot save plot: {e}")
        return

    lens = [len(v) for v in curves.values() if len(v) > 0]
    if not lens:
        print("[warn] No values to plot")
        return
    L = lens[0]
    for k, v in curves.items():
        if len(v) != L:
            raise ValueError(f"Curve '{k}' length {len(v)} does not match others {L}")

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    gens = list(range(L))
    plt.figure()
    for name, values in curves.items():
        if len(values) == 0:
            continue
        plt.plot(gens, values, label=name)
    plt.title(title)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    if log_y:
        plt.yscale("log")
    plt.grid(True, which="both", alpha=0.3)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path, dpi=dpi)
    plt.close()


def save_curves_csv(curves: Dict[str, Sequence[float]], out_csv_path: str) -> None:
    if not out_csv_path:
        return
    lens = [len(v) for v in curves.values() if len(v) > 0]
    if not lens:
        print("[warn] No values to save to CSV")
        return
    L = lens[0]
    os.makedirs(os.path.dirname(out_csv_path) or ".", exist_ok=True)
    keys = list(curves.keys())
    with open(out_csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["gen"] + keys)
        for i in range(L):
            writer.writerow([i] + [curves[k][i] if i < len(curves[k]) else "" for k in keys])
