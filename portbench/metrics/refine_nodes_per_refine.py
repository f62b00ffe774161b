"""Device operations a memetic refinement launches: the replayed block's
CUDA graph nodes (kernels, copies, fills) whose span path runs through
ga.refine, over the refinements the program counted in the capture
(profiling.count("ga.refine")). None where the program has neither."""


def read(rec):
    if rec.kind != "ga" or rec.trace is None:
        return None
    return rec.trace.get("refine_nodes_per_refine")
