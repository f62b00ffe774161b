"""The fused value and gradient's share of its roofline in the traced
memetic GA blocks: the least time of every refinement step's walk over the
elites, counted from their genomes (portbench/roofline.py's
gradient_least_s, as fused_walk_roofline_pct counts it), over the device
time of K7 and its sums. None outside a memetic GA record and where no K7
ran."""
import importlib

roofline = importlib.import_module("portbench.roofline")

FUSED = ("K7", "K6-K7-sums")  # kernels.json's names: K7 and the sums K6 and K7 share


def read(rec):
    t = rec.trace
    if (rec.kind != "ga" or t is None or "grad_walks" not in t
            or t["by_kernel"].get("K7", 0.0) <= 0.0):
        return None
    busy = sum(t["by_kernel"].get(k, 0.0) for k in FUSED)
    least = roofline.gradient_least_s(t["grad_pair_px"], t["grad_pair_cols"], t["grad_walks"],
                                      rec.H, rec.W, rec.n_splats)
    return 100.0 * least / busy
