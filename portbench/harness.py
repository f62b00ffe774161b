"""What every driver shares: the timed window, the comparisons and the
record that the metric readers read."""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Callable, Optional

import torch


def timed_window(block: Callable[[], None], units: int, seconds: float,
                 clock: Callable[[], float] = time.perf_counter):
    """Runs whole blocks (each ends synchronised with the card) until
    `seconds` have passed -> (units of work done, seconds from the window's
    start to the end of its last block, blocks). The rate is all the work
    over all that time: a stall in any block lowers it."""
    t0 = clock()
    n = 0
    while True:
        block()
        n += 1
        t = clock()
        if t - t0 >= seconds:
            return n * units, t - t0, n


def record(**kw) -> SimpleNamespace:
    """The record a metric reader reads: kind (whatever the cell's driver
    sets: "ga", "adam", ...; a reader tests rec.kind and reads nothing in
    another driver's cells), setup_s, window (units, seconds, blocks; None
    in a traced run), best_mse_end, trace (trace.profile's reading, its
    "spans" among it, with the units, pairs and nodes_per_unit the driver
    adds; None in a timed run), and the cell's shapes."""
    base = dict(kind=None, setup_s=None, window=None, best_mse_end=None, trace=None)
    base.update(kw)
    return SimpleNamespace(**base)


def window_rate(rec, kind: str) -> Optional[float]:
    """The window's units of work over its seconds, in a `kind` cell's
    timed run; None elsewhere."""
    if rec.kind != kind or rec.window is None:
        return None
    return rec.window["units"] / rec.window["seconds"]


def rel_gap(prog, ref) -> float:
    """The largest |prog - ref| / |ref| over paired values."""
    p = torch.as_tensor(prog, dtype=torch.float64).reshape(-1).cpu()
    r = torch.as_tensor(ref, dtype=torch.float64).reshape(-1).cpu()
    return float(torch.max(torch.abs(p - r) / torch.abs(r)))


def column_gap(prog: torch.Tensor, ref: torch.Tensor,
               keep: Optional[torch.Tensor] = None) -> float:
    """Genome-shaped [..., 9] tensors, each gene column a leaf: the largest
    gap between the program's and the reference's column norms, over the
    larger of that column's reference norm and the median column's."""
    pn = prog.reshape(-1, 9).double().norm(dim=0).cpu()
    rn = ref.reshape(-1, 9).double().norm(dim=0).cpu()
    gap = (pn - rn).abs() / torch.maximum(rn, rn.median())
    if keep is not None:
        gap = gap[keep.cpu()]
    return float(gap.max())


def max_rel_diff(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |prog - ref| over the largest |ref| (0 for equal tensors)."""
    p, r = prog.double().cpu(), ref.double().cpu()
    return float((p - r).abs().max() / r.abs().max().clamp_min(1e-300))


def fingerprints(pop: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """[P, N, 9] -> [P] float64: each genome's dot product with a fixed
    random vector. Equal genomes give equal fingerprints."""
    P = pop.shape[0]
    v = torch.rand(pop[0].numel(), generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64).to(pop.device)
    return torch.cat([c.reshape(c.shape[0], -1).double() @ v for c in pop.split(chunk)]).cpu()[:P]


def check(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": float(value), "limit": float(limit)}


def device_info(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_cache(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
