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
