"""Device milliseconds a generation in the memetic refinement: the self
time of the program span ga.refine and of every span inside it (the
elites' Adam steps, the accept's scoring; by portbench/spans.py). None
where the program opens no ga.refine span."""
import importlib

spans = importlib.import_module("portbench.spans")


def read(rec):
    t = rec.trace
    if not spans.has_spans(t) or not any("ga.refine" in path.split("/")
                                         for path in t["spans"]["self_s"]):
        return None
    return spans.ms_per_unit(rec, "ga", ["ga.refine"])
