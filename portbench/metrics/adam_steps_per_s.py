"""Adam value-and-gradient steps over the timed window, over the window's
seconds (from its start to the synchronised end of its last block)."""
import importlib

harness = importlib.import_module("portbench.harness")


def read(rec):
    return harness.window_rate(rec, "adam")
