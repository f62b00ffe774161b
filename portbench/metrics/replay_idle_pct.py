"""The share of the traced window in which a replayed graph holds the card
idle between its own operations: 100 x the idle time between the first and
last operation of each replay over the window (by portbench/spans.py).
None where no graph was replayed or the program has no spans. Its names
with a suffix (.adam) read the same in their cells."""
import importlib

spans = importlib.import_module("portbench.spans")


def read(rec):
    t = rec.trace
    if not spans.has_spans(t) or not t["spans"]["replays"]:
        return None
    return 100.0 * t["spans"]["replay_idle_s"] / t["window_s"]
