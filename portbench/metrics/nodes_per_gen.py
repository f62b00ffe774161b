"""Device operations a GA generation launches: the replayed block's CUDA
graph nodes (kernels, copies, fills) over its generations, or, where the
block stays eager, the traced operations over the traced generations."""


def read(rec):
    if rec.kind != "ga" or rec.trace is None:
        return None
    return rec.trace["nodes_per_unit"]
