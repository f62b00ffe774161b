"""Search operators: tournament selection and mutation, batched over the
population.

PyTorch counterpart of `ggs_tpu/models/operators.py` (modules/genetic.py:8-93).
Each random operator is split in two: `draw_*(gen, ...)` returns its random
numbers as tensors, and `apply_*(..., draws)` is deterministic. The JAX
package's mutation draws for individual i come from its own key splits;
here the same draws carry a leading population axis, so one `apply` call
mutates the whole population. Contracts kept: the per-group >= 1 mutated
gene guarantees, theta wrapping, genome clamping, and the z-order swap.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from ..ops import codec


def draw_tournament(gen: torch.Generator, P: int, num: int, k: int, device) -> torch.Tensor:
    """Entrant indices [num, k], uniform with replacement over [0, P)."""
    return torch.randint(0, P, (num, k), generator=gen, device=device)


def apply_tournament(fits: torch.Tensor, entrants: torch.Tensor) -> torch.Tensor:
    """Winner of each tournament [num]: the entrant with the lowest fitness,
    ties to the earliest draw (modules/genetic.py:8-14)."""
    win = torch.argmin(fits[entrants], dim=1)
    return torch.gather(entrants, 1, win[:, None])[:, 0]


def draw_mutation(gen: torch.Generator, P: int, N: int, device) -> Dict[str, torch.Tensor]:
    """Every random number of one mutation of a [P, N, 9] population, in the
    shapes mutate_individual draws them, with a leading P axis."""

    def rand(*shape):
        return torch.rand((P, *shape), generator=gen, device=device)

    def randn(*shape):
        return torch.randn((P, *shape), generator=gen, device=device)

    def randint(hi):
        return torch.randint(0, hi, (P,), generator=gen, device=device)

    return {
        "u_xy": rand(N, 2), "u_ab": rand(N, 2), "u_t": rand(N, 1),
        "u_rgb": rand(N, 1), "u_a": rand(N, 1),
        "r_pair": randint(2 * N), "r_xy": randint(2 * N), "r_ab": randint(2 * N),
        "r_t": randint(N),
        "n_xy": randn(N, 2), "n_ab": randn(N, 2), "n_t": randn(N, 1), "n_rgba": randn(N, 4),
        "z_i": randint(max(N - 1, 1)), "z_u": rand(N),
    }


def _ensure_one_true(mask: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per individual: if its mask [N, c] is all False, set entry r (of the
    row-major flattening) True (modules/genetic.py:24-29)."""
    P = mask.shape[0]
    flat = mask.reshape(P, -1)
    onehot = torch.arange(flat.shape[1], device=mask.device)[None, :] == r[:, None]
    return torch.where(flat.any(dim=1, keepdim=True), flat, onehot).reshape(mask.shape)


def _zorder_swap(pop: torch.Tensor, z_i: torch.Tensor, z_u: torch.Tensor) -> torch.Tensor:
    """Per individual: pick i (drawn in [0, N-2]); among j > i with area
    exp(a)exp(b) strictly greater than splat i's, swap rows i and the one
    with the largest z_u; no-op without a candidate (modules/genetic.py:80-91)."""
    P, N, _ = pop.shape
    if N < 2:
        return pop
    ar = torch.arange(P, device=pop.device)
    size = torch.exp(pop[:, :, 2]) * torch.exp(pop[:, :, 3])  # [P, N]
    size_i = size[ar, z_i]
    cand = (torch.arange(N, device=pop.device)[None, :] > z_i[:, None]) & (size > size_i[:, None])
    j = torch.argmax(torch.where(cand, z_u, torch.full_like(z_u, -1.0)), dim=1)
    row_i = pop[ar, z_i]
    row_j = pop[ar, j]
    swapped = pop.clone()
    swapped[ar, z_i] = row_j
    swapped[ar, j] = row_i
    return torch.where(cand.any(dim=1)[:, None, None], swapped, pop)


def _sig_row(v):
    """A sigma as a factor of a [P, N, c] group: a float, or a [P] tensor of
    per-row sigmas as [P, 1, 1]."""
    return v[:, None, None] if torch.is_tensor(v) else v


def _sig_cols(vals, dev) -> torch.Tensor:
    """The sigmas of a group's c columns as one factor of [P, N, c]: floats
    as a [c] row, copied to the device without waiting for it (pinned
    memory, non-blocking); per-row [P] tensors as [P, 1, c]."""
    if torch.is_tensor(vals[0]):
        return torch.stack(vals, dim=-1)[:, None, :]
    row = torch.tensor(vals, dtype=torch.float32, pin_memory=dev.type == "cuda")
    return row.to(dev, non_blocking=True)


def _sig_factors(sig, dev):
    """The factors of the xy, a/b, theta and rgba groups of [P, N, 9]. `sig`
    is a dict (floats, or [P] tensors) or a sigma row already on the device,
    [1 or P, 8] in genome.SIG_COLS order (a run block's table row, or PT's
    per-row scaled rows), whose slices are views: no launch, no copy."""
    if torch.is_tensor(sig):
        s = sig[:, None, :]
        return s[..., 0:1], s[..., 1:3], s[..., 3:4], s[..., 4:8]
    return (_sig_row(sig["xy"]), _sig_cols([sig["alog"], sig["blog"]], dev),
            _sig_row(sig["theta"]), _sig_cols([sig["rgb"]] * 3 + [sig["alpha"]], dev))


def apply_mutation(
    pop: torch.Tensor,
    draws: Dict[str, torch.Tensor],
    sig: Union[Dict[str, Union[float, torch.Tensor]], torch.Tensor],
    mutpb: float,
    H: int,
    W: int,
    min_scale: float,
    max_scale: float,
) -> torch.Tensor:
    """Mutate an axes-angle population [P, N, 9] (mutate_individual for each
    row): Bernoulli(mutpb) gene-group masks with >= 1-True guarantees,
    Gaussian steps scaled by the annealed sigmas, clamping, z-order swap.
    The sigmas are all floats, or all [P] tensors giving each row its own
    (parallel tempering scales a replica's sigmas by sqrt(T_k / T_0),
    pt.py:116-122), or a device row [1 or P, 8] (_sig_factors)."""
    P, N, _ = pop.shape
    d = draws
    m_xy = d["u_xy"] < mutpb
    m_ab = d["u_ab"] < mutpb
    m_t = d["u_t"] < mutpb
    m_rgb_flag = d["u_rgb"] < mutpb
    m_a_flag = d["u_a"] < mutpb

    # >= 1 of the 2N rgb/alpha flags must fire (joint guarantee, genetic.py:47-53)
    m_pair = _ensure_one_true(torch.cat([m_rgb_flag, m_a_flag], dim=2), d["r_pair"])
    m_rgb_flag = m_pair[:, :, 0:1]
    m_a_flag = m_pair[:, :, 1:2]
    m_rgba = torch.cat([m_rgb_flag.expand(P, N, 3), m_a_flag], dim=2)

    m_xy = _ensure_one_true(m_xy, d["r_xy"])
    m_ab = _ensure_one_true(m_ab, d["r_ab"])
    m_t = _ensure_one_true(m_t, d["r_t"])

    sig_xy, sig_ab, sig_t, sig_rgba = _sig_factors(sig, pop.device)
    xy = pop[:, :, 0:2] + d["n_xy"] * sig_xy * m_xy
    ab = pop[:, :, 2:4] + d["n_ab"] * sig_ab * m_ab
    th = codec.wrap_angle(pop[:, :, 4:5] + d["n_t"] * sig_t * m_t)
    rgba = pop[:, :, 5:9] + d["n_rgba"] * sig_rgba * m_rgba

    out = torch.cat([xy, ab, th, rgba], dim=2)
    out = codec.clamp_genome(out, H, W, min_scale, max_scale)
    return _zorder_swap(out, d["z_i"], d["z_u"])
