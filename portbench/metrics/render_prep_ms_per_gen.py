"""Device milliseconds a generation in the render path before the walks:
the self time of the program spans render.screen (codec, preprocess,
boxes, padded target), render.bin (the dense binning or K5) and
render.feats (the walk's table; by portbench/spans.py). Its names with a
suffix (.p512, .p4096) read the same in their cells."""
import importlib

spans = importlib.import_module("portbench.spans")


def read(rec):
    return spans.ms_per_unit(rec, "ga", spans.RENDER_PREP)
