"""Device milliseconds an Adam step in the optimizer's update and the
projection: the self time of the program span adam.update (by
portbench/spans.py)."""
import importlib

spans = importlib.import_module("portbench.spans")


def read(rec):
    return spans.ms_per_unit(rec, "adam", ["adam.update"])
