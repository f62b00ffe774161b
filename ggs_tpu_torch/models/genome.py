"""Population initialization and mutation-sigma annealing.

PyTorch counterpart of `ggs_tpu/models/genome.py` (modules/population.py:6-46):
xy uniform in [0,1]; per-axis log-scales Beta-shaped in linear sigma
(Beta(m*c, (1-m)*c), m = 0.4 for a / 0.6 for b, c = 8) mapped to
[min_scale, max_scale*max(H,W)] and logged; theta uniform in (-pi, pi);
colors U(0, 256) and alpha U(180, 256), clamped to [0, 255].

Drawing and building are split: `draw_population` takes every random
number (the Beta variates from a numpy Generator seeded by the torch one,
since torch.distributions.Beta takes no generator), and `apply_population`
is deterministic, so a test can hand it the JAX package's own draws.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

_BETA_M = {"u_a": 0.4, "u_b": 0.6}
_BETA_C = 8.0


def _beta_params(m: float, concentration: float = _BETA_C):
    eps = 1e-6
    return m * max(concentration, eps) + eps, (1.0 - m) * max(concentration, eps) + eps


def draw_population(
    gen: torch.Generator, batch_size: int, n_splats: int, device
) -> Dict[str, torch.Tensor]:
    """Every random number of new_population, as tensors on `device`."""
    B, N = batch_size, n_splats
    dev = torch.device(device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    # one host read of the torch stream seeds the Beta sampler
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=dev).item())
    rng = np.random.default_rng(seed)
    draws = {
        "xy": rand(B, N, 2),
        "theta": rand(B, N, 1) * (2.0 * math.pi) - math.pi,
        "rgb": rand(B, N, 3) * 256.0,
        "alpha": rand(B, N, 1) * 76.0 + 180.0,
    }
    for name, m in _BETA_M.items():
        a, b = _beta_params(m)
        u = rng.beta(a, b, size=(B, N, 1)).astype(np.float32)
        draws[name] = torch.from_numpy(u).to(dev)
    return draws


def apply_population(
    draws: Dict[str, torch.Tensor], H: int, W: int, min_scale: float = 3.0, max_scale: float = 0.1
) -> torch.Tensor:
    """Draws -> axes-angle population [B, N, 9]."""
    s_lo = float(min_scale)
    s_hi = float(max_scale * float(max(H, W)))
    a = torch.log(s_lo + draws["u_a"] * (s_hi - s_lo))
    b = torch.log(s_lo + draws["u_b"] * (s_hi - s_lo))
    G = torch.cat([draws["xy"], a, b, draws["theta"], draws["rgb"], draws["alpha"]], dim=-1)
    G[..., 0:2] = torch.clamp(G[..., 0:2], 0.0, 1.0)
    G[..., 5:9] = torch.clamp(G[..., 5:9], 0.0, 255.0)
    return G


def new_population(
    gen: torch.Generator,
    batch_size: int,
    n_splats: int,
    H: int,
    W: int,
    min_scale: float = 3.0,
    max_scale: float = 0.1,
    device="cuda",
) -> torch.Tensor:
    """Fresh axes-angle population [B, N, 9] (modules/population.py:20-46)."""
    draws = draw_population(gen, batch_size, n_splats, device)
    return apply_population(draws, H, W, min_scale, max_scale)


def _f32_op(fn, *args) -> np.float32:
    """fn of float32 arguments, correctly rounded to float32 (evaluated in
    float64, then rounded), as XLA's cos, log and pow nearly always are
    and numpy's float32 cos and power are not."""
    return np.float32(fn(*(np.float64(a) for a in args)))


def anneal_factor(gen: int, total: int, kind: str) -> float:
    """Mutation-sigma decay in [0, 1] (modules/utils.py:15-28), in float32
    like the JAX package's traced version."""
    f32 = np.float32
    g = f32(min(max(gen, 0), total))
    p = g / f32(max(1, total))
    if kind == "cosine":
        raw = f32(0.5) * (f32(1.0) + _f32_op(np.cos, f32(math.pi) * p))
    elif kind == "exp":
        decay = f32(0.2 ** (1.0 / max(1, total)))
        raw = _f32_op(np.power, decay, g)
    else:  # "linear" and unknown kinds fall back to linear, like the reference
        raw = f32(1.0) - p
    return float(max(f32(raw), f32(0.0)))


def build_mut_sigma(gen: int, total: int, kind: str, sig_max: dict, sig_min: dict) -> dict:
    """Lerp min<->max per gene group by the anneal factor (modules/utils.py:31-33),
    each value rounded to float32."""
    f = np.float32(anneal_factor(gen, total, kind))
    return {
        k: float(np.float32(sig_min[k]) + f * np.float32(sig_max[k] - sig_min[k]))
        for k in sig_max
    }


# The columns of a mutation-sigma row: the sigma that scales each gene column
# of [x, y | a_log, b_log | theta | r, g, b, alpha] (x and y share one)
SIG_COLS = ("xy", "alog", "blog", "theta", "rgb", "rgb", "rgb", "alpha")


def _anneal_factors(gens: np.ndarray, total: int, kind: str) -> np.ndarray:
    """anneal_factor of every gen in `gens`, with its float32 operations in
    the same order (cos and pow by _f32_op's float64 route)."""
    f32 = np.float32
    g = np.clip(gens, 0, total).astype(f32)
    p = g / f32(max(1, total))
    if kind == "cosine":
        raw = f32(0.5) * (f32(1.0) + np.cos((f32(math.pi) * p).astype(np.float64)).astype(f32))
    elif kind == "exp":
        decay = f32(0.2 ** (1.0 / max(1, total)))
        raw = np.power(np.float64(decay), g.astype(np.float64)).astype(f32)
    else:
        raw = f32(1.0) - p
    return np.maximum(raw, f32(0.0))


def mut_sigma_table(total: int, kind: str, sig_max: dict, sig_min: dict,
                    rows: int = 0) -> np.ndarray:
    """[rows, 8] float32 (rows defaults to total + 1): row g holds
    build_mut_sigma(g, total, kind, sig_max, sig_min) in SIG_COLS order, bit
    for bit. A run uploads it once and a step reads its row on the card."""
    f32 = np.float32
    f = _anneal_factors(np.arange(rows or total + 1), total, kind)
    cols = {k: f32(sig_min[k]) + f * f32(sig_max[k] - sig_min[k]) for k in sig_max}
    return np.stack([cols[k] for k in SIG_COLS], axis=1).astype(f32)


def temp_table(kind: str, T0: float, total: int, rows: int = 0) -> np.ndarray:
    """[rows] float32 (rows defaults to total + 1): entry i is
    temp_schedule(kind, T0, i, total), bit for bit."""
    f32 = np.float32
    it = np.arange(rows or total + 1).astype(f32)
    p = it / f32(max(1, total))
    floor = f32(1e-12)
    if kind == "linear":
        t = f32(T0) * (f32(1.0) - p)
    elif kind == "cosine":
        t = f32(T0 * 0.5) * (f32(1.0) + np.cos((f32(math.pi) * p).astype(np.float64)).astype(f32))
    elif kind == "log":
        t = f32(T0) / (f32(1.0) + np.log((f32(1.0) + f32(9.0) * it).astype(np.float64)).astype(f32))
    elif kind == "cauchy":
        t = f32(T0) / (f32(1.0) + it)
    else:
        r = f32(0.01 ** (1.0 / max(1, total)))
        return f32(T0) * np.power(np.float64(r), it.astype(np.float64)).astype(f32)
    return np.maximum(floor, t).astype(f32)


class StepRows:
    """A run's per-step float32 table on the device and the counter that
    picks a step's row: the port's form of the JAX package's traced `gen` /
    `it`, from which its jitted step computes the sigmas and temperature on
    the device. `start(n)` fills the counter (before a block, outside any
    graph); `row()` reads the row at the counter as [1, C] through a [1]
    index (a 0-d CUDA index would make the host wait), `advance()` adds 1.
    The table covers rows 0..len-1 and is rebuilt longer by `cover` when a
    block would read past it (make(rows) builds it on the host); `version`
    counts the rebuilds (a graph that read the old table is stale)."""

    def __init__(self, make, rows: int, device):
        self.make, self.device = make, torch.device(device)
        self.table = torch.from_numpy(np.ascontiguousarray(make(rows))).to(self.device)
        self.count = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.version = 0

    def cover(self, last: int) -> None:
        """Make row `last` readable."""
        n = self.table.shape[0]
        if last >= n:
            self.table = torch.from_numpy(
                np.ascontiguousarray(self.make(max(last + 1, 2 * n)))).to(self.device)
            self.version += 1

    def start(self, n: int) -> None:
        self.count.fill_(n)

    def row(self) -> torch.Tensor:
        return self.table.index_select(0, self.count)

    def advance(self) -> None:
        self.count.add_(1)


def temp_schedule(kind: str, T0: float, i: int, total: int) -> np.float32:
    """SA temperature at iteration i (modules/annealing.py:29-44).

    The JAX package computes it in float32 from a traced i; here i stays on
    the host and every operation rounds to float32 in the same order (cos,
    log and pow by _f32_op), so T, which feeds the acceptance test
    exp(-dE / T), matches to the ulp. Unknown kinds fall back to "exp",
    like the reference."""
    f32 = np.float32
    it = f32(i)
    p = it / f32(max(1, total))
    floor = f32(1e-12)
    if kind == "linear":
        return max(floor, f32(T0) * (f32(1.0) - p))
    if kind == "cosine":
        return max(floor, f32(T0 * 0.5) * (f32(1.0) + _f32_op(np.cos, f32(math.pi) * p)))
    if kind == "log":
        return max(floor, f32(T0) / (f32(1.0) + _f32_op(np.log, f32(1.0) + f32(9.0) * it)))
    if kind == "cauchy":
        return max(floor, f32(T0) / (f32(1.0) + it))
    r = 0.01 ** (1.0 / max(1, total))
    return f32(T0) * _f32_op(np.power, f32(r), it)
