"""Device milliseconds an Adam step outside K6 (with its sums), K2' and K5
(by the kernel table): the step's small kernels, copies and fills."""
import importlib

trace = importlib.import_module("portbench.trace")


def read(rec):
    t = rec.trace
    if rec.kind != "adam" or t is None:
        return None
    skip = set(trace.load_table()["groups"]["adam_walks"])
    return 1e3 * sum(v for k, v in t["by_kernel"].items() if k not in skip) / t["units"]
