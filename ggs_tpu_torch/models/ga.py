"""Generational GA with elitism, reduced to the port's first slice.

PyTorch counterpart of `ggs_tpu/models/ga.py` (modules/algorithm.py:85-163):
tournament-with-replacement, per-pair cxpb gating, annealed mutation
sigmas, elite_k best carried over (fitness cached, as in the JAX package),
1e-10 best-improvement epsilon, best/mean/median curves per generation.

`lax.scan` becomes a Python loop over generations: `run_block` keeps every
value on the device and the caller syncs once per block when it reads the
metrics. A step takes its random numbers from the state's torch.Generator,
or from `draws` when given (the tests hand it the JAX package's own draws).
With `memetic_every` set, the elites get a few Adam steps through the
differentiable renderer every that many generations (`run_memetic_block`).
Not ported yet: islands, meshes, scale-space annealing, recycling, growth,
checkpoint writing and video frames.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import GAConfig, GenomeConfig, GradConfig, MaskConfig, MutSigma
from ..ops import mask as mask_mod
from ..ops import objective as objective_mod
from ..ops.objective import Objective
from . import genome as genome_mod
from . import gradient, operators


class GAState(NamedTuple):
    pop: torch.Tensor  # [P, N, 9] axes-angle genomes
    fits: torch.Tensor  # [P]
    best: torch.Tensor  # [N, 9]
    best_fit: torch.Tensor  # scalar f32
    no_improve: torch.Tensor  # scalar i32
    rng: torch.Generator  # on the population's device
    gen: int


def _evaluate(obj, pop, target, weight_mask):
    return objective_mod.evaluate(obj, pop, target, weight_mask, device=pop.device)


def init(
    rng: torch.Generator,
    obj: Objective,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor],
    ga: GAConfig,
    gnm: GenomeConfig,
) -> GAState:
    """Fresh population on rng's device + initial evaluation (algorithm.py:55-68)."""
    pop = genome_mod.new_population(
        rng, ga.pop_size, gnm.n_splats, obj.H, obj.W, gnm.min_scale, gnm.max_scale,
        device=rng.device,
    )
    fits = _evaluate(obj, pop, target, weight_mask)
    b = torch.argmin(fits)
    return GAState(
        pop=pop, fits=fits, best=pop[b], best_fit=fits[b],
        no_improve=torch.zeros((), dtype=torch.int32, device=pop.device), rng=rng, gen=0,
    )


def draw_offspring(rng: torch.Generator, P: int, N: int, tour_k: int, device) -> Dict[str, torch.Tensor]:
    """Every random number of one generation's selection, crossover and
    mutation (ga._offspring's five keys, in order)."""
    return {
        "sel": operators.draw_tournament(rng, P, P, tour_k, device),
        "perm": torch.randperm(P, generator=rng, device=device),
        "u_cx": torch.rand((P // 2,), generator=rng, device=device),
        "u_cxm": torch.rand((P // 2, N), generator=rng, device=device),
        "mut": operators.draw_mutation(rng, P, N, device),
    }


def _offspring(
    pop: torch.Tensor, fits: torch.Tensor, draws: dict, ga: GAConfig, gen: int,
    obj: Objective, gnm: GenomeConfig, sig_max: dict, sig_min: dict,
) -> torch.Tensor:
    """Selection + crossover + mutation -> [P, N, 9] offspring."""
    P, N, _ = pop.shape
    # Tournament parents, then shuffle (algorithm.py:87-91)
    sel = operators.apply_tournament(fits, draws["sel"])
    parents = pop[sel][draws["perm"]]

    # Pair off; crossover each pair w.p. cxpb else clone (algorithm.py:94-100)
    a = parents[0::2]
    b = parents[1::2]
    do_cx = (draws["u_cx"] < ga.cxpb)[:, None, None]
    m = (draws["u_cxm"] < 0.5)[:, :, None]
    m_eff = m | ~do_cx  # not crossing -> child1 = a, child2 = b
    c1 = torch.where(m_eff, a, b)
    c2 = torch.where(m_eff, b, a)
    offspring = torch.stack([c1, c2], dim=1).reshape(P, N, 9)

    sig = genome_mod.build_mut_sigma(gen, ga.generations, ga.schedule, sig_max, sig_min)
    return operators.apply_mutation(
        offspring, draws["mut"], sig, ga.mutpb, obj.H, obj.W, gnm.min_scale, gnm.max_scale
    )


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle values on an even count."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


def step(
    state: GAState,
    obj: Objective,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor],
    ga: GAConfig,
    gnm: GenomeConfig,
    sig_max: dict,
    sig_min: dict,
    draws: Optional[dict] = None,
) -> Tuple[GAState, torch.Tensor]:
    """One generation. Returns (state, [best, mean, median, no_improve])."""
    P, N, _ = state.pop.shape
    # elitism always leaves at least one offspring slot
    E = max(1, min(ga.elite_k, P - 1)) if P > 1 else 1
    gen = state.gen + 1
    if draws is None:
        draws = draw_offspring(state.rng, P, N, ga.tour_k, state.pop.device)

    offspring = _offspring(state.pop, state.fits, draws, ga, gen, obj, gnm, sig_max, sig_min)
    off_fits = _evaluate(obj, offspring, target, weight_mask)

    # Elitism: the E best of the current population, ties to the lower
    # index as lax.top_k(-fits, E) keeps them (algorithm.py:129-141)
    elite_idx = torch.sort(state.fits, stable=True).indices[:E]
    elites = state.pop[elite_idx]
    if ga.reeval_elites:
        elite_fits = _evaluate(obj, elites, target, weight_mask)
    else:
        elite_fits = state.fits[elite_idx]

    pop = torch.cat([elites, offspring[: P - E]], dim=0)
    fits = torch.cat([elite_fits, off_fits[: P - E]], dim=0)

    gb = torch.argmin(fits)
    improved = fits[gb] + 1e-10 < state.best_fit
    best = torch.where(improved, pop[gb], state.best)
    best_fit = torch.where(improved, fits[gb], state.best_fit)
    no_improve = torch.where(improved, torch.zeros_like(state.no_improve), state.no_improve + 1)

    metrics = torch.stack(
        [best_fit, torch.mean(fits), _median(fits), no_improve.to(fits.dtype)]
    )
    return GAState(pop, fits, best, best_fit, no_improve, state.rng, gen), metrics


def run_block(
    state: GAState, obj: Objective, target, weight_mask, ga: GAConfig, gnm: GenomeConfig,
    num_gens: int,
) -> Tuple[GAState, torch.Tensor]:
    """num_gens generations with the default mutation sigmas, without a host
    sync -> (state, metrics [num_gens, 4])."""
    sig_max = MutSigma.max_defaults().__dict__
    sig_min = MutSigma.min_defaults().__dict__
    rows = []
    for _ in range(num_gens):
        state, m = step(state, obj, target, weight_mask, ga, gnm, sig_max, sig_min)
        rows.append(m)
    return state, torch.stack(rows)


def _refine(state: GAState, obj, target, weight_mask, gnm, grad_cfg, refine_steps, E) -> GAState:
    """Adam-refine the E elites (the first E of the population after a
    step); the best is updated on the same 1e-10 rule as a generation."""
    el, ef = gradient.refine_elites(
        state.pop[:E], state.fits[:E], target, weight_mask, obj, gnm, grad_cfg, refine_steps
    )
    pop = torch.cat([el, state.pop[E:]], dim=0)
    fits = torch.cat([ef, state.fits[E:]], dim=0)
    gb = torch.argmin(fits)
    improved = fits[gb] + 1e-10 < state.best_fit
    return GAState(
        pop, fits,
        torch.where(improved, pop[gb], state.best),
        torch.where(improved, fits[gb], state.best_fit),
        torch.where(improved, torch.zeros_like(state.no_improve), state.no_improve),
        state.rng, state.gen,
    )


def run_memetic_block(
    state: GAState, obj: Objective, target, weight_mask, ga: GAConfig, gnm: GenomeConfig,
    grad_cfg: GradConfig, refine_every: int, refine_steps: int, num_gens: int,
) -> Tuple[GAState, torch.Tensor]:
    """The hybrid GA+Adam block (ga.make_memetic_run_block): each generation
    is a plain step, and every refine_every-th is followed by `refine_steps`
    Adam steps on the elites, each kept only when it improved, so the best
    curve stays monotone. -> (state, metrics [num_gens, 4])."""
    sig_max = MutSigma.max_defaults().__dict__
    sig_min = MutSigma.min_defaults().__dict__
    E = max(1, ga.elite_k)
    rows = []
    for _ in range(num_gens):
        state, m = step(state, obj, target, weight_mask, ga, gnm, sig_max, sig_min)
        if state.gen % refine_every == 0:
            state = _refine(state, obj, target, weight_mask, gnm, grad_cfg, refine_steps, E)
        rows.append(torch.stack([state.best_fit, m[1], m[2], state.no_improve.to(m.dtype)]))
    return state, torch.stack(rows)


def genetic_approx(
    target_img,
    H: int,
    W: int,
    *,
    obj: Objective,
    ga: GAConfig,
    gnm: GenomeConfig,
    mask_cfg: Optional[MaskConfig] = None,
    seed: int = 42,
    log_every: int = 50,
    loss_png_path: str = "",
    loss_csv_path: str = "",
    device="cuda",
    memetic_every: int = 0,
    memetic_steps: int = 5,
    memetic_lr: float = 1e-2,
):
    """Host loop: a full GA run with loss curves (algorithm.py:17-195).

    The importance mask comes from every field of mask_cfg. `log_every`
    generations run per block, with one host sync and one progress line
    each. memetic_every > 0 runs the memetic block: every memetic_every
    generations the elites get memetic_steps Adam steps at memetic_lr.
    Returns (best_genome [N, 9] np, best_fit float, curves dict)."""
    from ..utils import curves as curves_mod
    from ..utils import io as io_mod

    dev = resolve_device(device)
    mask_cfg = mask_cfg if mask_cfg is not None else MaskConfig()
    target = io_mod.ensure_hw(target_img, H, W, device=dev)
    weight_mask = mask_mod.mask_from_config(target, H, W, mask_cfg)

    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    state = init(rng, obj, target, weight_mask, ga, gnm)
    curves = {
        "best": [float(state.best_fit)],
        "mean": [float(torch.mean(state.fits))],
        "median": [float(_median(state.fits))],
    }

    block_size = max(1, log_every)
    gen = 0
    try:
        while gen < ga.generations:
            block = min(block_size, ga.generations - gen)
            t_block = time.perf_counter()
            if memetic_every > 0:
                state, metrics = run_memetic_block(
                    state, obj, target, weight_mask, ga, gnm, GradConfig(lr=memetic_lr),
                    memetic_every, memetic_steps, block,
                )
            else:
                state, metrics = run_block(state, obj, target, weight_mask, ga, gnm, block)
            metrics = metrics.cpu().numpy()  # the block's one host sync
            gens_per_s = block / max(1e-9, time.perf_counter() - t_block)
            curves["best"].extend(metrics[:, 0].tolist())
            curves["mean"].extend(metrics[:, 1].tolist())
            curves["median"].extend(metrics[:, 2].tolist())
            gen += block
            print(
                f"gen {gen}/{ga.generations} best {metrics[-1, 0]:.6f} "
                f"stale {int(metrics[-1, 3])} {gens_per_s:.1f} gen/s",
                flush=True,
            )
    except KeyboardInterrupt:
        print("\n[Interrupted] Returning current best individual…", flush=True)

    try:
        curves_mod.save_loss_curve_png(
            curves, loss_png_path, title="ga fitness", xlabel="Generation",
            ylabel="MSE", log_y=True,
        )
        curves_mod.save_curves_csv(curves, loss_csv_path)
    except Exception as e:  # a plot must not lose the run's result
        print(f"[warn] Could not save loss curves: {e}")

    best = state.best.cpu().numpy()
    return best, float(state.best_fit), curves
