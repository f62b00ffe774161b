"""Parallel tempering (replica-exchange simulated annealing), ggs_tpu/models/pt.py.

K replicas explore on a geometric temperature ladder that anneals with the
SA schedule; every iteration the tries x K proposals score as ONE batch
(one K1 launch at B = tries * K), each replica Metropolis-accepts at its own
temperature, and every `swap_every` iterations neighbouring replicas swap
configurations with the replica-exchange acceptance

    p = min(1, exp((beta_i - beta_j) (E_i - E_j))),

alternating even and odd pairings so configurations diffuse across the
whole ladder. Mutation sigmas scale with sqrt(T_k / T_cold). As in
models/sa.py, a step draws from the state's generator or takes `draws`,
and a run block keeps every value on the device.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import GenomeConfig, MutSigma, SAConfig
from ..ops.objective import Objective
from . import genome as genome_mod
from . import operators
from .sa import _evaluate, _keep_best, _metropolis, graph_blocks, run_block


class PTState(NamedTuple):
    reps: torch.Tensor  # [K, N, 9] replica genomes (slot k holds temps[k])
    fits: torch.Tensor  # [K]
    temps: torch.Tensor  # [K] fixed ladder, temps[0] = coldest
    best: torch.Tensor  # [N, 9]
    best_fit: torch.Tensor  # scalar f32
    rng: torch.Generator  # on the state's device
    it: int

    @property
    def curr_fit(self) -> torch.Tensor:
        """The coldest replica's energy (the SA driver's "current" curve)."""
        return self.fits[0]


def temp_ladder(t_cold: float, t_hot: float, k: int, device="cpu") -> torch.Tensor:
    """Geometric ladder [k] from t_cold (slot 0) to t_hot (slot k-1), in
    float32 as the JAX package computes it, f32(t_cold) * f32(r) ** k, the
    power correctly rounded (genome._f32_op)."""
    f32 = np.float32
    if k == 1:
        ladder = np.array([t_cold], f32)
    else:
        r = (t_hot / t_cold) ** (1.0 / (k - 1))
        powers = genome_mod._f32_op(np.power, f32(r), np.arange(k, dtype=f32))
        ladder = f32(t_cold) * powers
    return torch.from_numpy(np.asarray(ladder, f32)).to(device)


def init(
    rng: torch.Generator,
    obj: Objective,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor],
    gnm: GenomeConfig,
    replicas: int,
    t_cold: float,
    t_hot: float,
) -> PTState:
    """K fresh replicas on rng's device, their energies and the best of them."""
    reps = genome_mod.new_population(
        rng, replicas, gnm.n_splats, obj.H, obj.W, gnm.min_scale, gnm.max_scale,
        device=rng.device,
    )
    fits = _evaluate(obj, reps, target, weight_mask)
    b = torch.argmin(fits)
    return PTState(
        reps=reps, fits=fits, temps=temp_ladder(t_cold, t_hot, replicas, rng.device),
        best=reps[b].clone(), best_fit=fits[b].clone(), rng=rng, it=0,
    )


def draw_step(rng: torch.Generator, tries: int, K: int, N: int, device) -> Dict:
    """Every random number of one PT iteration: `mut`, one mutation of the
    [tries * K, N, 9] proposals (row t * K + k mutates replica k),
    `u_acc` [tries, K] and `u_swap` [K]."""
    return {
        "mut": operators.draw_mutation(rng, tries * K, N, device),
        "u_acc": torch.rand((tries, K), generator=rng, device=device),
        "u_swap": torch.rand((K,), generator=rng, device=device),
    }


def _accept_chain(reps, fits, props, prop_fits, u_acc, temps_now):
    """Each replica's Metropolis chain over its tries (sa._metropolis,
    vectorized over K): props [tries, K, N, 9], prop_fits and u_acc [tries, K]."""
    T = torch.clamp_min(temps_now, 1e-30)
    for t in range(props.shape[0]):
        reps, fits, _ = _metropolis(u_acc[t], reps, fits, props[t], prop_fits[t], T)
    return reps, fits


def _swap(reps, fits, temps_now, u_swap, parity: int):
    """The neighbour swap sweep: slot i pairs with i + 1 when i % 2 ==
    parity, else with i - 1; the acceptance is computed on the left element
    and mirrored to the right (pt.py:149-170)."""
    K = fits.shape[0]
    i = torch.arange(K, device=fits.device)
    is_left = (i % 2) == parity
    partner = torch.where(is_left, i + 1, i - 1)
    valid = (partner >= 0) & (partner < K)
    partner = torch.clamp(partner, 0, K - 1)
    beta = 1.0 / torch.clamp_min(temps_now, 1e-30)
    arg = (beta - beta[partner]) * (fits - fits[partner])
    p = torch.exp(torch.clamp_max(arg, 0.0))
    u_pair = torch.where(is_left, u_swap, u_swap[partner])
    p_pair = torch.where(is_left, p, p[partner])
    do = valid & (u_pair < p_pair)
    new_i = torch.where(do, partner, i)
    return reps[new_i], fits[new_i]


def step(
    state: PTState,
    obj: Objective,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor],
    sa: SAConfig,
    gnm: GenomeConfig,
    sig_max: dict,
    sig_min: dict,
    swap_every: int,
    draws: Optional[Dict] = None,
    rows: Optional[genome_mod.StepRows] = None,
) -> Tuple[PTState, torch.Tensor]:
    """One PT iteration: tries x K proposals (one batch), K Metropolis
    chains and, when (it + 1) % swap_every == 0, a neighbour swap sweep.
    Returns (state, [best_fit, coldest_fit]). With `rows` (sa.step_table's
    StepRows with ratio, its counter holding state.it) the sigmas and the
    ladder factor are the table's row, read on the device."""
    K, N, _ = state.reps.shape
    it = state.it
    tries = sa.tries_per_iter
    dev = state.reps.device
    if rows is None:
        sig = genome_mod.build_mut_sigma(it, sa.iterations, sa.sigma_schedule, sig_max, sig_min)
    else:
        row = rows.row()
        rows.advance()
    if draws is None:
        draws = draw_step(state.rng, tries, K, N, dev)

    # the whole ladder anneals with the SA schedule (slot 0 follows the
    # single-chain SA temperature); the ladder fixes the slots' ratios.
    # Row t * K + k mutates replica k with its sigmas scaled by sqrt(T_k / T_0)
    row_scale = torch.sqrt(state.temps / state.temps[0]).repeat(tries)
    if rows is None:
        t_base = genome_mod.temp_schedule(sa.temp_schedule, sa.t0, it, sa.iterations)
        temps_now = state.temps * float(t_base / np.float32(sa.t0))
        sig_rows = {name: row_scale * v for name, v in sig.items()}
    else:
        temps_now = state.temps * row[:, 8]
        sig_rows = row_scale[:, None] * row[:, :8]
    props = operators.apply_mutation(
        state.reps.repeat(tries, 1, 1), draws["mut"], sig_rows, sa.mutpb, obj.H, obj.W,
        gnm.min_scale, gnm.max_scale,
    )
    prop_fits = _evaluate(obj, props, target, weight_mask).reshape(tries, K)
    reps, fits = _accept_chain(
        state.reps, state.fits, props.reshape(tries, K, N, 9), prop_fits, draws["u_acc"],
        temps_now,
    )
    if (it + 1) % swap_every == 0:
        reps, fits = _swap(reps, fits, temps_now, draws["u_swap"], (it // swap_every) % 2)

    # the global best, with the reference's 1e-12 epsilon (annealing.py:148);
    # indexed by a [1] tensor (a 0-d CUDA index is read on the host)
    b = torch.argmin(fits).reshape(1)
    best, best_fit = _keep_best(reps[b][0], fits[b][0], state.best, state.best_fit)

    new_state = PTState(reps, fits, state.temps, best, best_fit, state.rng, it + 1)
    return new_state, torch.stack([best_fit, fits[0]])


def make_run_block(
    obj: Objective,
    sa: SAConfig,
    gnm: GenomeConfig,
    sig_max: Optional[MutSigma] = None,
    sig_min: Optional[MutSigma] = None,
    swap_every: int = 10,
):
    """-> run(state, target, weight_mask, num_iters) -> (state, metrics
    [num_iters, 2]): pt.make_run_block, PT steps replayed as a CUDA graph on
    a card (sa.graph_blocks). Which iterations of a block swap, and with
    which parity, is decided on the host from state.it, so a graph is kept
    per it % (2 * swap_every) at the block's start: a swap may fall inside
    a block or on its boundary, and no iteration draws more than the eager
    step does."""
    eager = run_block(functools.partial(step, swap_every=swap_every), obj, sa, gnm, sig_max,
                      sig_min, ratio=True)
    return graph_blocks(obj, eager, PTState, phase=lambda it: it % (2 * swap_every))
