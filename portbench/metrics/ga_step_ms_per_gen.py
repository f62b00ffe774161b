"""Device milliseconds a generation in operations that are neither the
forward walks nor the binning: the GA step's small kernels, copies and
fills (by the kernel table, portbench/kernels.json)."""
import importlib

trace = importlib.import_module("portbench.trace")


def read(rec):
    t = rec.trace
    if rec.kind != "ga" or t is None:
        return None
    groups = trace.load_table()["groups"]
    skip = set(groups["forward_walk"]) | set(groups["binning"])
    return 1e3 * sum(v for k, v in t["by_kernel"].items() if k not in skip) / t["units"]
