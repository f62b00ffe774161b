"""Device milliseconds a generation of the GA's own operators: the self
time of the program spans under ga.step but outside objective.evaluate
(the draws, selection, crossover, mutation, elitism and metrics; by
portbench/spans.py). Its names with a suffix (.p512, .p4096) read the same
in their cells."""
import importlib

spans = importlib.import_module("portbench.spans")


def read(rec):
    return spans.ms_per_unit(rec, "ga", ["ga.step"], outside=["objective.evaluate"])
