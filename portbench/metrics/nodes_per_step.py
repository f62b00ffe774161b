"""Device operations an Adam step launches: the replayed block's CUDA graph
nodes (kernels, copies, fills) over its steps."""


def read(rec):
    if rec.kind != "adam" or rec.trace is None:
        return None
    return rec.trace["nodes_per_unit"]
