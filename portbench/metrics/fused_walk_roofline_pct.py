"""The fused value and gradient's share of its roofline in the traced Adam
blocks: the least time of every step's walk, counted from the genome
(portbench/roofline.py's gradient_least_s: 23 + 45 operations a
(splat, pixel) pair, 5 a (splat, column) pair), over the device time of K7
and its sums. The count leaves out the loss head's per-pixel work and its
reads of the target and the mask, as bwd_walk_roofline_pct's does. None in
a GA record and where no K7 ran (the chained Adam cell)."""
import importlib

roofline = importlib.import_module("portbench.roofline")

FUSED = ("K7", "K6-K7-sums")  # kernels.json's names: K7 and the sums K6 and K7 share


def read(rec):
    t = rec.trace
    if rec.kind != "adam" or t is None or t["by_kernel"].get("K7", 0.0) <= 0.0:
        return None
    busy = sum(t["by_kernel"].get(k, 0.0) for k in FUSED)
    least = roofline.gradient_least_s(t["pair_px"], t["pair_cols"], t["units"], rec.H, rec.W,
                                      rec.n_splats)
    return 100.0 * least / busy
