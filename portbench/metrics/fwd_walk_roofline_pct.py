"""The forward walks' share of their roofline in the traced GA blocks: the
least time of the fitness walks of every candidate scored, counted from
the genomes (portbench/roofline.py), over the device time of K1 and K2."""
import importlib

roofline = importlib.import_module("portbench.roofline")
trace = importlib.import_module("portbench.trace")


def read(rec):
    t = rec.trace
    if rec.kind != "ga" or t is None:
        return None
    busy = sum(t["by_kernel"].get(k, 0.0) for k in trace.load_table()["groups"]["forward_walk"])
    if busy <= 0.0:
        return None
    least = roofline.forward_least_s(t["pair_px"], t["pair_cols"], t["renders"], t["units"],
                                     rec.H, rec.W, rec.n_splats)
    return 100.0 * least / busy
