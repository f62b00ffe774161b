"""Device milliseconds an Adam step in the render path before the walks:
the self time of the program spans render.screen, render.bin and
render.feats (by portbench/spans.py), as render_prep_ms_per_gen reads a
generation."""
import importlib

spans = importlib.import_module("portbench.spans")


def read(rec):
    return spans.ms_per_unit(rec, "adam", spans.RENDER_PREP)
