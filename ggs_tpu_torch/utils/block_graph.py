"""Run blocks as CUDA graphs: captured once, replayed for every later block.

The JAX package runs each optimizer in run blocks, `jax.jit` over a
`lax.scan` of the step with the state donated (`donate_argnums=(0,)`),
traced once and replayed as one XLA program for every block of the same
length (ggs_tpu/models/ga.py:176-254, gradient.py:311-321, sa.py:133-150,
pt.py:182-202, parallel/island.py:175-208). `BlockGraphs` is the port's
counterpart: a block's eager body is captured into a `torch.cuda.CUDAGraph`
and replayed, so the host issues one graph launch a block instead of every
kernel of every step.

* One graph per key: the block length, the caller's phase (PT's position in
  its swap cycle, the memetic block's in its refine cycle, the island
  block's in its migration cycle), the inputs' shapes and dtypes (a None
  input, such as an absent weight mask or blur sigma, is part of it) and
  the generator; a new `epoch` (a per-step table rebuilt longer) drops
  them all.
* The first call of a key runs the eager body on the capture stream, and
  its result is that call's: the body's kernel builds, library loads,
  per-stream buffers and lazily made constants happen there, outside the
  graph. Then the cache is emptied (the warm-up's blocks would otherwise
  double the graph's pool) and the body is captured in the default
  (global) error mode, reading static input buffers, with the block's
  generator registered (`register_generator_state`: a replay advances it
  exactly as the eager steps do). Every later call copies the caller's
  tensors into the static inputs (device-to-device `copy_`, skipped for a
  tensor that already is one) and replays.
* Donation, as in JAX: a replay returns the graph's own output buffers as
  the new state and metrics, and the next call of any graph of the helper
  may overwrite them, so the caller reads a block's result before its next
  call and never reads a state it has passed in again. The graphs of one
  helper (one run) share a memory pool.
* A capture that fails raises, naming the op from its traceback, and so
  does a captured graph that copies from host memory (a copy whose source
  a replay would read stale). Nothing falls back to the eager body.
* Counts: the kernel wrappers count their launches in Python
  (profiling.count), which a replay does not pass through. A capture
  records what it advanced in profiling.COUNTS, sets it back, and each
  replay adds it, so the counts stay the kernels run (and a caller's own
  counted events stay those the block made).
* On the CPU (no capture) the helper runs the eager body: the plain version
  the tests use, and on a card the one chip_smoke compares replays with.
* Spans: a capture records where the capture stands at each program span's
  entry and exit (utils/profiling.span; cuStreamGetCaptureInfo's last
  node), then walks the captured chain once and keeps, for each kernel,
  copy and fill node in chain order, the path of spans open around it
  (`_Graph.spans`): a replay's device operations, which a trace correlates
  only to the graph's launch, are named by it. The replay branch opens
  `block.replay`, the first call of a key `block.capture`.

Which blocks stay eager (the rule; there is no switch): every block under
a `torch.distributed` mesh (gloo collectives sync through host memory) and
every block whose objective scores in chunks (`Objective.chunk`, run_ga
--eval-chunk: the chunks exist because the batch barely fits, and a
graph's private pool needs more than the eager peak; the card is busy
there anyway). `stays_eager` is the rule. Every other block is replayed:
the GA, memetic, island, Adam, SA and PT blocks. A block whose host
branches depend on where it starts (the memetic refinement every
`refine_every` generations, the island migration every `migrate_every`,
PT's swaps) passes that residue as the graphs' `phase`.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import gc
from typing import Callable, Dict, NamedTuple, Optional

import torch

from . import profiling


def stays_eager(obj) -> bool:
    """True where an objective's run blocks stay eager: under a mesh, or
    scoring in chunks (see the module's docstring)."""
    return obj.mesh is not None or obj.chunk is not None


class RunBlock:
    """What a make_run_block returns: run(state, target, weight_mask, n,
    ...) calls `graphed` (the block replayed through `graphs`) or, where
    the blocks stay eager, `eager`; `prepare(state, n)` and `loop(state,
    target, weight_mask, n, ...)` are the eager block's two parts (the
    per-run table's check and counter fill, then the steps). An object and
    not attributes on a function, so a run that goes out of use holds no
    reference cycle and frees its graphs at once."""

    def __init__(self, eager, graphed, graphs, prepare, loop, use_graphs: bool, **extra):
        self.eager, self.graphed, self.graphs = eager, graphed, graphs
        self.prepare, self.loop, self.use_graphs = prepare, loop, use_graphs
        self.__dict__.update(extra)

    def __call__(self, *args, **kw):
        return (self.graphed if self.use_graphs else self.eager)(*args, **kw)


def _take_delta(before: collections.Counter) -> collections.Counter:
    """What profiling.COUNTS advanced since `before` (a copy of it); sets it
    back to `before`."""
    delta = profiling.COUNTS - before
    profiling.COUNTS.clear()
    profiling.COUNTS.update(before)
    return delta


# CUgraphNodeType 0-13 and CUmemorytype
NODE_KINDS = ("KERNEL", "MEMCPY", "MEMSET", "HOST", "GRAPH", "EMPTY", "WAIT_EVENT",
              "EVENT_RECORD", "EXT_SEMAS_SIGNAL", "EXT_SEMAS_WAIT", "MEM_ALLOC", "MEM_FREE",
              "BATCH_MEM_OP", "CONDITIONAL")
_MEM_HOST, _MEM_UNIFIED = 1, 4
_PTR_MEMORY_TYPE = 2  # CU_POINTER_ATTRIBUTE_MEMORY_TYPE


class _Memcpy3D(ctypes.Structure):
    """CUDA_MEMCPY3D (cuda.h)."""

    _fields_ = [(f"{s}{f}", t) for s in ("src", "dst") for f, t in (
        ("XInBytes", ctypes.c_size_t), ("Y", ctypes.c_size_t), ("Z", ctypes.c_size_t),
        ("LOD", ctypes.c_size_t), ("MemoryType", ctypes.c_int), ("Host", ctypes.c_void_p),
        ("Device", ctypes.c_uint64), ("Array", ctypes.c_void_p), ("Reserved", ctypes.c_void_p),
        ("Pitch", ctypes.c_size_t), ("Height", ctypes.c_size_t))] + [
        ("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
        ("Depth", ctypes.c_size_t)]


def _cu_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} returned CUresult {rc}")


@functools.lru_cache(maxsize=None)
def _libcuda():
    """libcuda's graph, capture and pointer queries, their argument and
    result types declared (the edge and capture queries where this libcuda
    has them)."""
    cu = ctypes.CDLL("libcuda.so.1")
    p, out = ctypes.c_void_p, ctypes.c_void_p  # handles; out-parameters by reference
    for name, args in (("cuGraphGetNodes", (p, out, out)), ("cuGraphNodeGetType", (p, out)),
                       ("cuGraphMemcpyNodeGetParams", (p, out)),
                       ("cuPointerGetAttribute", (out, ctypes.c_int, ctypes.c_uint64)),
                       ("cuGraphGetEdges", (p, out, out, out)),
                       ("cuStreamGetCaptureInfo_v2", (p, out, out, out, out, out))):
        fn = getattr(cu, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, ctypes.c_int
    return cu


_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE
UNKNOWN = object()  # a capture position that could not be read


def _capture_tail(stream: int):
    """The node a stream's capture would make its next node depend on: its
    last captured node, None before the first (or when not capturing), or
    UNKNOWN where that cannot be told (a capture that forks, a libcuda
    without the query). Never raises: a capture goes on without it."""
    fn = getattr(_libcuda(), "cuStreamGetCaptureInfo_v2", None)
    status, n = ctypes.c_int(0), ctypes.c_size_t(0)
    deps = ctypes.POINTER(ctypes.c_void_p)()
    if fn is None or fn(stream, ctypes.byref(status), None, None, ctypes.byref(deps),
                        ctypes.byref(n)) != 0:
        return UNKNOWN
    if status.value != _CAPTURE_ACTIVE or n.value == 0:
        return None
    return deps[0] if n.value == 1 else UNKNOWN


def _nodes(cu, raw: int) -> list:
    n = ctypes.c_size_t(0)
    _cu_check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu_check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    return list(nodes)


def _kind(cu, node) -> str:
    t = ctypes.c_int(-1)
    _cu_check(cu.cuGraphNodeGetType(node, ctypes.byref(t)), "cuGraphNodeGetType")
    return NODE_KINDS[t.value] if 0 <= t.value < len(NODE_KINDS) else f"TYPE_{t.value}"


def _graph_chain(raw: int) -> Optional[list]:
    """A captured graph's nodes in dependency order, where it is one chain
    (every node has at most one dependency and one dependent); else None."""
    cu = _libcuda()
    nodes = _nodes(cu, raw)
    if not nodes or getattr(cu, "cuGraphGetEdges", None) is None:
        return [] if not nodes else None
    n = ctypes.c_size_t(0)
    _cu_check(cu.cuGraphGetEdges(raw, None, None, ctypes.byref(n)), "cuGraphGetEdges")
    src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    _cu_check(cu.cuGraphGetEdges(raw, src, dst, ctypes.byref(n)), "cuGraphGetEdges")
    after = dict(zip(src, dst))
    if len(after) != len(src) or len(set(dst)) != len(dst) or len(src) != len(nodes) - 1:
        return None
    node = next(iter(set(nodes) - set(dst)), None)
    chain = []
    while node is not None:
        chain.append(node)
        node = after.get(node)
    return chain if len(chain) == len(nodes) else None


DEVICE_KINDS = ("KERNEL", "MEMCPY", "MEMSET")


def span_paths(chain: list, marks: list) -> list:
    """The span path ("ga.step/objective.evaluate", "" outside every span)
    of each node of a captured chain. marks: in the order recorded, (name,
    node) where a span opened and (None, node) where the innermost open one
    closed, `node` the chain's last node at that moment (None before the
    first). ValueError where a mark names no node of the chain (UNKNOWN
    among them), steps back or closes no open span."""
    at_node = {node: i + 1 for i, node in enumerate(chain)}
    out, stack, at = [], [], 0
    for name, node in marks:
        if node is not None and node not in at_node:
            raise ValueError("a span mark names a node outside the chain")
        k = at_node.get(node, 0)
        if k < at:
            raise ValueError("the span marks step back along the chain")
        out += ["/".join(stack)] * (k - at)
        at = k
        if name is None:
            if not stack:
                raise ValueError("a span mark closes no open span")
            stack.pop()
        else:
            stack.append(name)
    return out + ["/".join(stack)] * (len(chain) - at)


def _span_table(raw: int, marks: list) -> Optional[tuple]:
    """The span path of each kernel, copy and fill node of a captured graph
    in chain order (span_paths), or None where it is no chain."""
    chain = _graph_chain(raw)
    if chain is None:
        return None
    try:
        paths = span_paths(chain, marks)
    except ValueError:  # a position that could not be read, or a mark out of order
        return None
    cu = _libcuda()
    return tuple(p for node, p in zip(chain, paths) if _kind(cu, node) in DEVICE_KINDS)


def graph_nodes(raw: int) -> tuple:
    """(Counter of a captured graph's node kinds, the number of its copies
    whose source is host memory), through libcuda (cuGraphGetNodes,
    cuGraphNodeGetType, cuGraphMemcpyNodeGetParams, cuPointerGetAttribute)."""
    cu = _libcuda()
    kinds, host_copies = collections.Counter(), 0
    for node in _nodes(cu, raw):
        kind = _kind(cu, node)
        kinds[kind] += 1
        if kind != "MEMCPY":
            continue
        p = _Memcpy3D()
        _cu_check(cu.cuGraphMemcpyNodeGetParams(node, ctypes.byref(p)),
                  "cuGraphMemcpyNodeGetParams")
        src = p.srcMemoryType
        if src == _MEM_UNIFIED:
            mt = ctypes.c_uint(0)
            rc = cu.cuPointerGetAttribute(ctypes.byref(mt), _PTR_MEMORY_TYPE, p.srcDevice)
            src = mt.value if rc == 0 else _MEM_HOST  # unregistered: pageable host memory
        host_copies += src == _MEM_HOST
    return kinds, host_copies


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static: Dict[str, Optional[torch.Tensor]]
    out: object
    delta: collections.Counter  # what the capture counted in profiling.COUNTS
    nodes: collections.Counter
    rng: Optional[torch.Generator]
    # the span path of each KERNEL, MEMCPY and MEMSET node in chain order
    # (span_paths); None where the capture did not record them as a chain
    spans: Optional[tuple]


def _empty_like(inputs: dict) -> dict:
    return {k: None if v is None else torch.empty_like(v) for k, v in inputs.items()}


class BlockGraphs:
    """body(inputs, n, host, rng) -> out runs n steps eagerly: `inputs` a
    dict of tensors (or None), `host` the state's step count (a Python int
    the body may branch on; `phase` must then tell apart the branches a
    block takes), `rng` the generator it draws from (or None), `out` any
    structure of tensors. static(inputs) gives the buffers a
    capture reads (default: new ones of the same shapes; a body that updates
    its inputs in place, as Adam does, passes them through instead)."""

    def __init__(self, body: Callable, static: Callable = _empty_like):
        self.body, self.static = body, static
        self.graphs: Dict[tuple, _Graph] = {}
        self.pool = self.stream = None
        self.last: Optional[_Graph] = None  # the graph of the last call (chip_smoke reads it)
        self.replays = 0
        self.epoch = 0

    def __call__(self, inputs: dict, n: int, host: int, rng=None, phase=(), epoch: int = 0):
        """`epoch` changes when something the graphs read outside `inputs`
        moved (a StepRows table rebuilt): every graph is dropped."""
        dev = next(v.device for v in inputs.values() if v is not None)
        if dev.type != "cuda":
            return self.body(inputs, n, host, rng)
        if epoch != self.epoch:
            self.graphs.clear()
            self.epoch = epoch
        shapes = tuple((k, None if v is None else (tuple(v.shape), v.dtype))
                       for k, v in inputs.items())
        key = (n, phase, shapes, id(rng))
        e = self.graphs.get(key)  # an entry holds its generator: its id is not reused
        if e is not None:
            with profiling.span("block.replay"):
                for k, v in inputs.items():
                    if v is not None and v is not e.static[k]:
                        e.static[k].copy_(v)
                e.graph.replay()
                profiling.COUNTS.update(e.delta)
            self.last = e
            self.replays += 1
            return e.out
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
            self.pool = torch.cuda.graph_pool_handle()
        with profiling.span("block.capture"):
            cur = torch.cuda.current_stream(dev)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                out = self.body(inputs, n, host, rng)
            cur.wait_stream(self.stream)
            self.graphs[key] = self.last = self._capture(inputs, n, host, rng)
        return out

    def _capture(self, inputs: dict, n: int, host: int, rng) -> _Graph:
        static = self.static(inputs)
        # a graph freed while another is captured (a collected cycle's)
        # invalidates the capture: no collection during it. torch.cuda.graph
        # synchronizes and empties the cache (the warm-up's blocks) first.
        g = torch.cuda.CUDAGraph(keep_graph=True)
        if rng is not None:
            g.register_generator_state(rng)
        before = collections.Counter(profiling.COUNTS)
        marks = []
        stream = self.stream.cuda_stream

        def mark(name):
            marks.append((name, _capture_tail(stream)))

        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g, pool=self.pool, stream=self.stream), \
                    profiling.capturing(mark):
                out = self.body(static, n, host, rng)
        except Exception as e:
            raise RuntimeError(f"capturing a {n}-step run block as a CUDA graph failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
            delta = _take_delta(before)
        raw = g.raw_cuda_graph()
        kinds, host_copies = graph_nodes(raw)
        if host_copies:
            raise RuntimeError(f"the captured {n}-step run block copies from host memory "
                               f"{host_copies} times; a replay would read stale values")
        g.instantiate()
        return _Graph(g, static, out, delta, kinds, rng, _span_table(raw, marks))
