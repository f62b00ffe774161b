"""Device milliseconds a generation in the binning: the dense binning's
integer sorts, and K5 where it runs (by the kernel table)."""
import importlib

trace = importlib.import_module("portbench.trace")


def read(rec):
    t = rec.trace
    if rec.kind != "ga" or t is None:
        return None
    keep = trace.load_table()["groups"]["binning"]
    return 1e3 * sum(t["by_kernel"].get(k, 0.0) for k in keep) / t["units"]
