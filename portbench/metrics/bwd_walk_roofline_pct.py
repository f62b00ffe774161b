"""The gradient walks' share of their roofline in the traced Adam blocks:
the least time of a value and gradient of every step, counted from the
genome (portbench/roofline.py), over the device time of K6 (with its
sums) and the K2' forward of the chained passes."""
import importlib

roofline = importlib.import_module("portbench.roofline")
trace = importlib.import_module("portbench.trace")


def read(rec):
    t = rec.trace
    if rec.kind != "adam" or t is None:
        return None
    busy = sum(t["by_kernel"].get(k, 0.0) for k in trace.load_table()["groups"]["gradient_walk"])
    if busy <= 0.0:
        return None
    least = roofline.gradient_least_s(t["pair_px"], t["pair_cols"], t["units"], rec.H, rec.W,
                                      rec.n_splats)
    return 100.0 * least / busy
