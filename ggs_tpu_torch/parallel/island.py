"""Island-model GA: deme-local evolution with ring migration.

PyTorch counterpart of `ggs_tpu/parallel/island.py`. The population [P, N, 9] is split into `n_islands` demes of S = P / I
candidates; selection, crossover and elitism stay within a deme (batched
over a leading [I, S] island axis with S-bounded indices), and every
`migrate_every` generations each deme's `migrate_k` best ride a ring to the
next deme, replacing its `migrate_k` worst (`_migrate_roll`); under a
mesh the ring runs over the pop shards instead (shard.migrate_ring,
island.py:126-133), while the evaluation splits over the mesh.

As in models/ga.py, a step takes its random numbers from the state's
torch.Generator, or from `draws` when given (the tests hand it the JAX
package's own draws), and a run block keeps every value on the device: the
generation counter is a host int, so whether a generation migrates is a
host `if`, not a device branch; `make_run_block` replays the block as a
CUDA graph on a card, keyed by where it starts in the migration cycle.
Ties keep JAX's order: `lax.top_k` keeps the lower index first among equal
values, so the elites, the migrants and the worst slots come from stable
sorts, and the deme shuffle is a stable argsort of uniforms as
`jnp.argsort` is. With one island the step equals models/ga.step on the
same draws (the shuffle's permutation being the argsort of its uniforms).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import GAConfig, GenomeConfig, MutSigma
from ..models import genome as genome_mod, operators
from ..models.ga import GAState, _evaluate, _graphed_run_block, _median, _sigma_tables
from ..ops import anneal as anneal_mod
from ..ops.objective import Objective


def draw_island(rng: torch.Generator, I: int, S: int, N: int, tour_k: int, device) -> Dict:
    """Every random number of one island generation (island.step's keys
    k_sel, k_shuf, k_cx, k_cxm and k_mut, in order): tournament entrants
    [I, S, tour_k] in [0, S), shuffle uniforms [I, S], crossover uniforms
    [I, S/2] and [I, S/2, N], and one mutation of the [I * S, N, 9] offspring."""
    return {
        "sel": torch.randint(0, S, (I, S, tour_k), generator=rng, device=device),
        "u_shuf": torch.rand((I, S), generator=rng, device=device),
        "u_cx": torch.rand((I, S // 2), generator=rng, device=device),
        "u_cxm": torch.rand((I, S // 2, N), generator=rng, device=device),
        "mut": operators.draw_mutation(rng, I * S, N, device),
    }


def _island_tournament(fits_i: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-island tournaments on [I, S] fitness over entrants idx [I, S, k]:
    local winner indices [I, S] in [0, S), ties to the earliest entrant."""
    I, S = fits_i.shape
    k = idx.shape[2]
    cand = torch.gather(fits_i, 1, idx.reshape(I, S * k)).reshape(I, S, k)
    win = torch.argmin(cand, dim=2, keepdim=True)
    return torch.gather(idx, 2, win)[..., 0]


def _island_shuffle(x_i: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Shuffle [I, S, ...] rows independently within each island: the stable
    argsort of the uniforms u [I, S]."""
    order = torch.argsort(u, dim=1, stable=True)
    return x_i[torch.arange(x_i.shape[0], device=x_i.device)[:, None], order]


def _migrate_roll(pop: torch.Tensor, fits: torch.Tensor, k: int, n_islands: int):
    """Ring migration over island blocks: island i's k best (ties to the
    lower index) replace island i+1's k worst (ties to the lower index);
    the donors keep their copies."""
    P = pop.shape[0]
    S = P // n_islands
    pop_s = pop.reshape(n_islands, S, *pop.shape[1:])
    fits_s = fits.reshape(n_islands, S)
    ar = torch.arange(n_islands, device=pop.device)[:, None]
    best_idx = torch.sort(fits_s, dim=1, stable=True).indices[:, :k]
    worst_idx = torch.sort(fits_s, dim=1, descending=True, stable=True).indices[:, :k]
    migrants = torch.roll(pop_s[ar, best_idx], 1, dims=0)
    migrant_fits = torch.roll(fits_s[ar, best_idx], 1, dims=0)
    # worst_idx holds k distinct slots a row, so the writes never collide
    pop_s = pop_s.clone()
    fits_s = fits_s.clone()
    pop_s[ar, worst_idx] = migrants
    fits_s[ar, worst_idx] = migrant_fits
    return pop_s.reshape(pop.shape), fits_s.reshape(P)


def step(
    state: GAState,
    obj: Objective,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor],
    ga: GAConfig,
    gnm: GenomeConfig,
    sig_max: dict,
    sig_min: dict,
    n_islands: int,
    migrate_every: int = 0,
    migrate_k: int = 1,
    draws: Optional[Dict] = None,
    blur_sigma: Optional[torch.Tensor] = None,
    mesh=None,
    rows: Optional[genome_mod.StepRows] = None,
) -> Tuple[GAState, torch.Tensor]:
    """One island-GA generation over the [P, N, 9] population. Returns
    (state, [best, mean, median, no_improve]) as ga.step does; blur_sigma
    and rows (the sigmas read on the device) as in ga.step; with mesh the
    migration ring runs over its pop shards."""
    P, N, _ = state.pop.shape
    I = n_islands
    S = P // I
    E = max(1, min(ga.elite_k, S - 1))
    gen = state.gen + 1
    if draws is None:
        draws = draw_island(state.rng, I, S, N, ga.tour_k, state.pop.device)

    pop_i = state.pop.reshape(I, S, N, 9)
    fits_i = state.fits.reshape(I, S)
    ar = torch.arange(I, device=pop_i.device)[:, None]
    parents = pop_i[ar, _island_tournament(fits_i, draws["sel"])]
    parents = _island_shuffle(parents, draws["u_shuf"])

    a = parents[:, 0::2]  # [I, S/2, N, 9]: pairs stay within their deme
    b = parents[:, 1::2]
    do_cx = (draws["u_cx"] < ga.cxpb)[:, :, None, None]
    m = (draws["u_cxm"] < 0.5)[:, :, :, None]
    m_eff = m | ~do_cx
    c1 = torch.where(m_eff, a, b)
    c2 = torch.where(m_eff, b, a)
    offspring = torch.stack([c1, c2], dim=2).reshape(P, N, 9)

    if rows is not None:
        rows.advance()
        sig = rows.row()
    else:
        sig = genome_mod.build_mut_sigma(gen, ga.generations, ga.schedule, sig_max, sig_min)
    offspring = operators.apply_mutation(
        offspring, draws["mut"], sig, ga.mutpb, obj.H, obj.W, gnm.min_scale, gnm.max_scale
    )
    if blur_sigma is not None:
        off_fits = _evaluate(obj, anneal_mod.blur_genome_axes(offspring, blur_sigma), target,
                             weight_mask)
    else:
        off_fits = _evaluate(obj, offspring, target, weight_mask)

    # per-island elitism: the E best of each deme, ties to the lower index
    elite_idx = torch.sort(fits_i, dim=1, stable=True).indices[:, :E]  # [I, E]
    elites = pop_i[ar, elite_idx]
    elite_fits = fits_i[ar, elite_idx]

    off_i = offspring.reshape(I, S, N, 9)
    offf_i = off_fits.reshape(I, S)
    pop = torch.cat([elites, off_i[:, : S - E]], dim=1).reshape(P, N, 9)
    fits = torch.cat([elite_fits, offf_i[:, : S - E]], dim=1).reshape(P)

    if migrate_every and I > 1 and gen % migrate_every == 0:
        if mesh is not None:
            from .shard import migrate_ring

            pop, fits = migrate_ring(pop, fits, migrate_k, mesh)
        else:
            pop, fits = _migrate_roll(pop, fits, migrate_k, I)

    gb = torch.argmin(fits).reshape(1)  # a [1] index: no host sync
    cand, cand_fit = pop[gb][0], fits[gb][0]
    improved = cand_fit + 1e-10 < state.best_fit
    best = torch.where(improved, cand, state.best)
    best_fit = torch.where(improved, cand_fit, state.best_fit)
    no_improve = torch.where(improved, torch.zeros_like(state.no_improve), state.no_improve + 1)

    metrics = torch.stack(
        [best_fit, torch.mean(fits), _median(fits), no_improve.to(fits.dtype)]
    )
    return GAState(pop, fits, best, best_fit, no_improve, state.rng, gen), metrics


def make_run_block(
    obj: Objective,
    ga: GAConfig,
    gnm: GenomeConfig,
    n_islands: int,
    migrate_every: int = 0,
    migrate_k: int = 1,
    sig_max: Optional[MutSigma] = None,
    sig_min: Optional[MutSigma] = None,
    mesh=None,
):
    """-> run(state, target, weight_mask, num_gens) -> (state, metrics
    [num_gens, 4]): island steps without a host sync (mesh: see step), the
    sigmas read on the device from the run's table. A block_graph.RunBlock
    as ga.make_run_block's: on a card a CUDA graph replayed per (length,
    state.gen % migrate_every, shapes, generator), which fixes the
    generations of the block that migrate; under a mesh or obj.chunk it
    stays eager (block_graph.stays_eager: gloo stages its collectives
    through host memory). Raises ValueError when the population does not
    split into demes of an even size, or migrate_k does not fit a deme."""
    from ..utils.block_graph import stays_eager

    if ga.pop_size % n_islands:
        raise ValueError(f"pop_size {ga.pop_size} must divide into n_islands {n_islands}")
    S = ga.pop_size // n_islands
    if n_islands > 1 and S % 2:
        raise ValueError(
            "island demes need an even size for within-deme pairing: "
            f"pop_size {ga.pop_size} / n_islands {n_islands} is odd"
        )
    if migrate_every and n_islands > 1 and not 1 <= migrate_k <= S:
        raise ValueError(f"migrate_k {migrate_k} must lie in [1, {S}], the deme size")
    tables, prepare = _sigma_tables(ga, sig_max, sig_min)
    migrates = bool(migrate_every) and n_islands > 1

    def loop(state: GAState, target, weight_mask, num_gens: int):
        rows = tables[str(state.pop.device)]
        out = []
        for _ in range(num_gens):
            state, m = step(state, obj, target, weight_mask, ga, gnm, {}, {}, n_islands,
                            migrate_every, migrate_k, mesh=mesh, rows=rows)
            out.append(m)
        return state, torch.stack(out)

    return _graphed_run_block(prepare, loop,
                              (lambda gen: gen % migrate_every) if migrates else (lambda gen: ()),
                              mesh is None and not stays_eager(obj))
