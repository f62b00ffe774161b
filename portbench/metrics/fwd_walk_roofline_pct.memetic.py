"""The forward walks' share of their roofline in the traced memetic GA
blocks: the least time of the fitness walks of every candidate the GA
scored and of every elite a refinement's accept scored, counted from the
genomes (portbench/roofline.py, as fwd_walk_roofline_pct counts it), over
the device time of K1 and K2. None outside a memetic GA record."""
import importlib

roofline = importlib.import_module("portbench.roofline")
trace = importlib.import_module("portbench.trace")


def read(rec):
    t = rec.trace
    if rec.kind != "ga" or t is None or "accepts" not in t:
        return None
    busy = sum(t["by_kernel"].get(k, 0.0) for k in trace.load_table()["groups"]["forward_walk"])
    if busy <= 0.0:
        return None
    # an accept reads the target and mask once, as a generation does
    least = roofline.forward_least_s(t["pair_px"] + t["accept_pair_px"],
                                     t["pair_cols"] + t["accept_pair_cols"],
                                     t["renders"] + t["accept_renders"],
                                     t["units"] + t["accepts"], rec.H, rec.W, rec.n_splats)
    return 100.0 * least / busy
