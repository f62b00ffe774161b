"""Generational GA with elitism, reduced to the port's first slice.

PyTorch counterpart of `ggs_tpu/models/ga.py` (modules/algorithm.py:85-163):
tournament-with-replacement, per-pair cxpb gating, annealed mutation
sigmas, elite_k best carried over (fitness cached, as in the JAX package),
1e-10 best-improvement epsilon, best/mean/median curves per generation.

`lax.scan` becomes a Python loop over generations: `run_block` keeps every
value on the device and the caller syncs once per block when it reads the
metrics; `make_run_block`, JAX's jitted block, captures that loop into a
CUDA graph once and replays it (utils/block_graph.py). The step's mutation
sigmas are then read on the card from a table of the whole run
(genome.StepRows), as JAX computes them from its traced `gen`. A step takes
its random numbers from the state's torch.Generator, or from `draws` when
given (the tests hand it the JAX package's own draws).
With `memetic_every` set, the elites get a few Adam steps through the
differentiable renderer every that many generations
(`make_memetic_run_block`, also replayed as a CUDA graph).
`genetic_approx` also runs scale-space annealing (`blur_sigma`, ops/anneal.py),
the densify+prune recycle (models/grow.py), stall-ended stages for growth,
warm starts from a population, video frames, the island model
(parallel/island.py), checkpoints and resume (utils/checkpoint.py), a
torch.profiler trace of one block (utils/profiling.py) and meshes
(`mesh`, ga.py:366-389): every rank of a (pop, tile) grid of processes runs
the whole GA on the whole population with the same seeded generator, and
only the evaluation is split over the grid (parallel/shard.py); rank 0
alone prints and writes the frames, curves and checkpoints.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import GAConfig, GenomeConfig, GradConfig, MaskConfig, MutSigma
from ..ops import anneal as anneal_mod
from ..ops import codec as codec_mod
from ..ops import mask as mask_mod
from ..ops import objective as objective_mod
from ..ops.objective import Objective
from . import genome as genome_mod
from ..utils import profiling
from . import gradient, grow, operators


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
    init_pop=None,
) -> GAState:
    """Fresh population on rng's device + initial evaluation (algorithm.py:55-68).

    init_pop warm-starts from an existing [pop_size, N, 9] axes-angle
    population (a smaller stage's grown result, or a coarser resolution's
    rescaled by codec.scale_genome_pixels_anisotropic); it is clamped to
    this resolution's scale domain before evaluation."""
    if init_pop is not None:
        pop = torch.as_tensor(init_pop, dtype=torch.float32, device=rng.device)
        if tuple(pop.shape) != (ga.pop_size, gnm.n_splats, 9):
            raise ValueError(f"init_pop has shape {tuple(pop.shape)}, not "
                             f"{(ga.pop_size, gnm.n_splats, 9)}")
        pop = codec_mod.clamp_genome(pop, obj.H, obj.W, gnm.min_scale, gnm.max_scale)
    else:
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
    with profiling.span("ga.draw"):
        return {
            "sel": operators.draw_tournament(rng, P, P, tour_k, device),
            "perm": torch.randperm(P, generator=rng, device=device),
            "u_cx": torch.rand((P // 2,), generator=rng, device=device),
            "u_cxm": torch.rand((P // 2, N), generator=rng, device=device),
            "mut": operators.draw_mutation(rng, P, N, device),
        }


def _offspring(
    pop: torch.Tensor, fits: torch.Tensor, draws: dict, ga: GAConfig, gen: int,
    obj: Objective, gnm: GenomeConfig, sig_max: dict, sig_min: dict, sig=None,
) -> torch.Tensor:
    """Selection + crossover + mutation -> [P, N, 9] offspring; `sig`, a
    device sigma row, replaces build_mut_sigma(gen, ...)'s floats."""
    with profiling.span("ga.variation"):
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

        if sig is None:
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
    blur_sigma: Optional[torch.Tensor] = None,
    rows: Optional[genome_mod.StepRows] = None,
) -> Tuple[GAState, torch.Tensor]:
    """One generation. Returns (state, [best, mean, median, no_improve]).

    With `blur_sigma` (a 0-d tensor), candidates are evaluated at scale sigma
    (anneal.blur_genome_axes) against a caller-blurred target; the
    population itself evolves unblurred. With `rows` (a mut_sigma_table's
    StepRows whose counter holds state.gen) the sigmas are the table's row
    of the new generation, read on the device, the counter advanced; else
    build_mut_sigma's floats from sig_max and sig_min."""
    with profiling.span("ga.step"):
        P, N, _ = state.pop.shape
        # elitism always leaves at least one offspring slot
        E = max(1, min(ga.elite_k, P - 1)) if P > 1 else 1
        gen = state.gen + 1
        if draws is None:
            draws = draw_offspring(state.rng, P, N, ga.tour_k, state.pop.device)

        def at_scale(g):
            return g if blur_sigma is None else anneal_mod.blur_genome_axes(g, blur_sigma)

        sig = None
        if rows is not None:
            rows.advance()
            sig = rows.row()
        offspring = _offspring(state.pop, state.fits, draws, ga, gen, obj, gnm, sig_max, sig_min,
                               sig)
        off_fits = _evaluate(obj, at_scale(offspring), target, weight_mask)

        with profiling.span("ga.elitism"):
            # Elitism: the E best of the current population, ties to the lower
            # index as lax.top_k(-fits, E) keeps them (algorithm.py:129-141)
            elite_idx = torch.sort(state.fits, stable=True).indices[:E]
            elites = state.pop[elite_idx]
            if ga.reeval_elites:
                elite_fits = _evaluate(obj, at_scale(elites), target, weight_mask)
            else:
                elite_fits = state.fits[elite_idx]

            pop = torch.cat([elites, offspring[: P - E]], dim=0)
            fits = torch.cat([elite_fits, off_fits[: P - E]], dim=0)

            # a [1] index: indexing by a 0-d CUDA tensor synchronises with the host
            gb = torch.argmin(fits).reshape(1)
            cand, cand_fit = pop[gb][0], fits[gb][0]
            improved = cand_fit + 1e-10 < state.best_fit
            best = torch.where(improved, cand, state.best)
            best_fit = torch.where(improved, cand_fit, state.best_fit)
            no_improve = torch.where(improved, torch.zeros_like(state.no_improve),
                                     state.no_improve + 1)

            metrics = torch.stack(
                [best_fit, torch.mean(fits), _median(fits), no_improve.to(fits.dtype)]
            )
            return GAState(pop, fits, best, best_fit, no_improve, state.rng, gen), metrics


_SIGMA_ROWS: dict = {}


def _sigma_rows(ga: GAConfig, sig_max: dict, sig_min: dict, device) -> genome_mod.StepRows:
    """The run's mutation-sigma table (a row a generation) on `device`."""
    return genome_mod.StepRows(
        functools.partial(genome_mod.mut_sigma_table, ga.generations, ga.schedule, sig_max,
                          sig_min), ga.generations + 1, device)


def run_block(
    state: GAState, obj: Objective, target, weight_mask, ga: GAConfig, gnm: GenomeConfig,
    num_gens: int, blur_sigma: Optional[torch.Tensor] = None,
    rows: Optional[genome_mod.StepRows] = None,
) -> Tuple[GAState, torch.Tensor]:
    """num_gens generations, without a host sync -> (state, metrics
    [num_gens, 4]); blur_sigma as in step. The eager body of make_run_block:
    the sigmas are read from `rows` (its counter holding state.gen), or,
    without rows, from the default sigmas' table (uploaded once a process
    and device) with its counter filled from state.gen."""
    if rows is None:
        key = (ga.generations, ga.schedule, str(state.pop.device))
        rows = _SIGMA_ROWS.get(key)
        if rows is None:
            rows = _SIGMA_ROWS[key] = _sigma_rows(ga, MutSigma.max_defaults().__dict__,
                                                  MutSigma.min_defaults().__dict__,
                                                  state.pop.device)
        rows.cover(state.gen + num_gens)
        rows.start(state.gen)
    out = []
    for _ in range(num_gens):
        state, m = step(state, obj, target, weight_mask, ga, gnm, {}, {}, blur_sigma=blur_sigma,
                        rows=rows)
        out.append(m)
    return state, torch.stack(out)


def _sigma_tables(ga: GAConfig, sig_max: Optional[MutSigma], sig_min: Optional[MutSigma]):
    """-> (tables, prepare): a run's mutation-sigma tables by device, and
    prepare(state, num_gens), which uploads the state's device's table once,
    makes it cover the block and fills its counter from state.gen."""
    sig_max_d = (sig_max or MutSigma.max_defaults()).__dict__
    sig_min_d = (sig_min or MutSigma.min_defaults()).__dict__
    tables: Dict[str, genome_mod.StepRows] = {}

    def prepare(state: GAState, num_gens: int) -> genome_mod.StepRows:
        with profiling.span("block.prepare"):
            dev = str(state.pop.device)
            if dev not in tables:
                tables[dev] = _sigma_rows(ga, sig_max_d, sig_min_d, state.pop.device)
            tables[dev].cover(state.gen + num_gens)
            tables[dev].start(state.gen)
            return tables[dev]

    return tables, prepare


def _graphed_run_block(prepare, loop, phase_of, use_graphs: bool):
    """The block_graph.RunBlock of a GAState block: loop(state, target,
    weight_mask, num_gens, **kw) the steps (kw: blur_sigma, for the plain
    GA), prepare(state, num_gens) its sigma table's fill, phase_of(gen) what
    the block's host branches depend on besides its length (the graphs' key:
    () for none)."""
    from ..utils.block_graph import BlockGraphs, RunBlock

    def body(inp, n, gen0, rng):
        st = GAState(inp["pop"], inp["fits"], inp["best"], inp["best_fit"], inp["no_improve"],
                     rng, gen0)
        kw = {"blur_sigma": inp["blur_sigma"]} if "blur_sigma" in inp else {}
        st, metrics = loop(st, inp["target"], inp["weight_mask"], n, **kw)
        return tuple(st[:5]), metrics

    graphs = BlockGraphs(body)

    def eager(state: GAState, target, weight_mask, num_gens: int, **kw):
        prepare(state, num_gens)
        return loop(state, target, weight_mask, num_gens, **kw)

    def graphed(state: GAState, target, weight_mask, num_gens: int, **kw):
        rows = prepare(state, num_gens)
        inputs = {"pop": state.pop, "fits": state.fits, "best": state.best,
                  "best_fit": state.best_fit, "no_improve": state.no_improve, "target": target,
                  "weight_mask": weight_mask, **kw}
        out, metrics = graphs(inputs, num_gens, state.gen, rng=state.rng,
                              phase=phase_of(state.gen), epoch=rows.version)
        return GAState(*out, state.rng, state.gen + num_gens), metrics

    return RunBlock(eager, graphed, graphs, prepare, loop, use_graphs)


def make_run_block(
    obj: Objective,
    ga: GAConfig,
    gnm: GenomeConfig,
    sig_max: Optional[MutSigma] = None,
    sig_min: Optional[MutSigma] = None,
):
    """-> run(state, target, weight_mask, num_gens, blur_sigma=None) ->
    (state, metrics [num_gens, 4]): ga.make_run_block. On a card the block
    is a CUDA graph captured at the first call of each (length, shapes,
    blur on/off, generator) and replayed after (utils/block_graph.py): the
    state is donated, so read the returned state and metrics before the
    next call and never reuse a state passed in. The sigma table is
    uploaded once; its counter is filled from state.gen before each block.
    Under obj.mesh or obj.chunk the block stays eager
    (block_graph.stays_eager; `run.graphed` is the graphed block all the
    same, for measuring it). A block_graph.RunBlock: `run.eager` is the
    same block run eagerly (chip_smoke holds replays to it),
    run.prepare(state, n) and run.loop(state, target, weight_mask, n,
    blur_sigma) its two parts, `run.graphs` the BlockGraphs."""
    from ..utils.block_graph import stays_eager

    tables, prepare = _sigma_tables(ga, sig_max, sig_min)

    def loop(state: GAState, target, weight_mask, num_gens: int, blur_sigma=None):
        return run_block(state, obj, target, weight_mask, ga, gnm, num_gens,
                         blur_sigma=blur_sigma, rows=tables[str(state.pop.device)])

    return _graphed_run_block(prepare, loop, lambda gen: (), not stays_eager(obj))


def _refine(state: GAState, refine, E: int, target, weight_mask) -> GAState:
    """The E elites (the first E of the population after a step) through
    refine(elites, fits, target, weight_mask) (gradient.make_refine); the
    best is updated on the same 1e-10 rule as a generation."""
    el, ef = refine(state.pop[:E], state.fits[:E], target, weight_mask)
    pop = torch.cat([el, state.pop[E:]], dim=0)
    fits = torch.cat([ef, state.fits[E:]], dim=0)
    gb = torch.argmin(fits).reshape(1)  # a [1] index: no host sync
    cand, cand_fit = pop[gb][0], fits[gb][0]
    improved = cand_fit + 1e-10 < state.best_fit
    return GAState(
        pop, fits,
        torch.where(improved, cand, state.best),
        torch.where(improved, cand_fit, state.best_fit),
        torch.where(improved, torch.zeros_like(state.no_improve), state.no_improve),
        state.rng, state.gen,
    )


def make_memetic_run_block(
    obj: Objective,
    ga: GAConfig,
    gnm: GenomeConfig,
    grad_cfg: GradConfig,
    refine_every: int,
    refine_steps: int,
    sig_max: Optional[MutSigma] = None,
    sig_min: Optional[MutSigma] = None,
):
    """-> run(state, target, weight_mask, num_gens) -> (state, metrics
    [num_gens, 4]): the hybrid GA+Adam block (ga.make_memetic_run_block).
    Each generation is a plain step, and every refine_every-th is followed
    by `refine_steps` Adam steps on the E = max(1, elite_k) elites
    (gradient.make_refine, built once for the run), each kept only when the
    GA's own evaluator scores it lower, so the best curve stays monotone;
    metrics column 0 is the best after the refinement, column 3 the stall
    count. A block_graph.RunBlock as make_run_block's: on a card a CUDA
    graph replayed per (length, state.gen % refine_every, shapes,
    generator), which fixes the generations of the block that refine."""
    from ..utils.block_graph import stays_eager

    tables, prepare = _sigma_tables(ga, sig_max, sig_min)
    E = max(1, ga.elite_k)
    refine = gradient.make_refine(obj, gnm, grad_cfg, refine_steps)

    def loop(state: GAState, target, weight_mask, num_gens: int):
        rows = tables[str(state.pop.device)]
        out = []
        for _ in range(num_gens):
            state, m = step(state, obj, target, weight_mask, ga, gnm, {}, {}, rows=rows)
            if state.gen % refine_every == 0:
                with profiling.span("ga.refine"):
                    state = _refine(state, refine, E, target, weight_mask)
                profiling.count("ga.refine")
            out.append(torch.stack([state.best_fit, m[1], m[2], state.no_improve.to(m.dtype)]))
        return state, torch.stack(out)

    return _graphed_run_block(prepare, loop, lambda gen: gen % refine_every,
                              not stays_eager(obj))


def run_memetic_block(
    state: GAState, obj: Objective, target, weight_mask, ga: GAConfig, gnm: GenomeConfig,
    grad_cfg: GradConfig, refine_every: int, refine_steps: int, num_gens: int,
    sig_max: Optional[MutSigma] = None, sig_min: Optional[MutSigma] = None,
) -> Tuple[GAState, torch.Tensor]:
    """make_memetic_run_block's block run once, eagerly -> (state, metrics
    [num_gens, 4])."""
    run = make_memetic_run_block(obj, ga, gnm, grad_cfg, refine_every, refine_steps, sig_max,
                                 sig_min)
    return run.eager(state, target, weight_mask, num_gens)


def _rescore(state: GAState, obj, target, weight_mask, sigma) -> GAState:
    """sigma stepped: the population and the tracked best scored again on the
    new landscape (sigma None: unblurred), so the elites' stored fits and the
    best tracking stay commensurate with the next block's energies; the
    stall counter restarts (ga.py:430-458)."""
    def at(g):
        return g if sigma is None else anneal_mod.blur_genome_axes(g, sigma)

    fits = _evaluate(obj, at(state.pop), target, weight_mask)
    best_fit = _evaluate(obj, at(state.best[None]), target, weight_mask)[0]
    return state._replace(fits=fits, best_fit=best_fit,
                          no_improve=torch.zeros_like(state.no_improve))


def genetic_approx(
    target_img,
    H: int,
    W: int,
    *,
    obj: Objective,
    ga: GAConfig,
    gnm: GenomeConfig,
    mask_cfg: Optional[MaskConfig] = None,
    sig_max: Optional[MutSigma] = None,
    sig_min: Optional[MutSigma] = None,
    seed: int = 42,
    log_every: int = 50,
    save_video: bool = False,
    frame_every: int = 5000,
    video_dir: str = "",
    prefix: str = "ga",
    loss_png_path: str = "",
    loss_csv_path: str = "",
    device="cuda",
    init_pop=None,
    return_state: bool = False,
    recycle_every: int = 0,
    recycle_k: int = 0,
    recycle_patience: int = 0,
    stall_patience: int = 0,
    weight_mask=None,
    anneal_sigma0: float = 0.0,
    anneal_frac: float = 0.6,
    memetic_every: int = 0,
    memetic_steps: int = 5,
    memetic_lr: float = 1e-2,
    checkpoint_path: str = "",
    checkpoint_every: int = 0,
    resume_from: str = "",
    n_islands: int = 1,
    migrate_every: int = 0,
    migrate_k: int = 1,
    profile_dir: str = "",
    mesh=None,
):
    """Host loop: a full GA run with loss curves and frames (algorithm.py:17-195).

    `log_every` generations run per block, with one host sync each; every
    trigger below reads that block's metrics. The importance mask comes from
    every field of mask_cfg unless `weight_mask` [H, W] is given.
    `init_pop` warm-starts from a population (see init). sig_max and sig_min
    are the mutation sigmas' bounds (MutSigma's defaults when None), which
    every mode's block anneals between.
    save_video writes the best's frame every `frame_every` generations to
    video_dir/{prefix}_{gen}.png (the block shrinks to that cadence).
    recycle_every/recycle_k: every recycle_every generations each candidate's
    recycle_k lowest-impact splats are replaced by error-guided ones
    (grow.recycle_population) and the population is scored again;
    recycle_patience also recycles when the best has stalled that many
    generations (and restarts the stall count). stall_patience ends the run
    when the best has stalled that many generations (a growth stage).
    anneal_sigma0 > 0: scale-space annealing, candidates scored at scale
    sigma against the sigma-blurred target, sigma decaying from anneal_sigma0
    to 0 over the first anneal_frac of the budget; at each sigma step the
    population and the best are scored again, so the curves during the
    anneal are energies of the current smoothed landscape. The mask stays
    the unblurred target's. memetic_every > 0 runs the memetic block: every
    memetic_every generations the elites get memetic_steps Adam steps at
    memetic_lr (exclusive with annealing, as in the JAX package).
    n_islands > 1 runs the island model (parallel/island.py): demes of
    pop_size / n_islands with their own selection and elitism, migrate_k
    migrants around the ring every migrate_every generations (single-deme
    memetic refinement and annealing refuse it). checkpoint_every > 0 saves
    the state with its generation and curves to checkpoint_path after each
    block that crosses a multiple of it; resume_from continues such a run
    from its file, bit for bit (frames from generation 0 are not written
    again). profile_dir writes a torch.profiler trace of the first block
    after the starting one. mesh (parallel/mesh.Mesh) evaluates over its
    (pop, tile) grid of processes (shard.sharded_objective): the state stays
    replicated and identical on every rank, rank 0 alone prints and writes
    the frames, curves and checkpoints (save_checkpoint_distributed), and
    the island model migrates over the pop shards (shard.migrate_ring).
    Returns (best_genome [N, 9] np, best_fit float, curves dict), and the
    final population [P, N, 9] np too with return_state."""
    from ..utils import checkpoint as ckpt_mod
    from ..utils import curves as curves_mod
    from ..utils import io as io_mod
    from ..utils import profiling

    if memetic_every > 0 and anneal_sigma0 > 0.0:
        raise ValueError("memetic refinement and scale-space annealing are mutually exclusive "
                         "(the memetic block has no sigma input)")
    if n_islands > 1 and (memetic_every > 0 or anneal_sigma0 > 0.0):
        raise ValueError("memetic refinement and scale-space annealing are single-deme only "
                         "(n_islands must be 1)")
    main = mesh is None or mesh.is_main
    if mesh is not None:
        from ..parallel import shard

        obj = shard.sharded_objective(obj, mesh)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    mask_cfg = mask_cfg if mask_cfg is not None else MaskConfig()
    target = io_mod.ensure_hw(target_img, H, W, device=dev)
    if weight_mask is None:
        weight_mask = mask_mod.mask_from_config(target, H, W, mask_cfg)
    else:
        # a caller-fixed mask, e.g. run_ga --fixed-mask's, resized per stage
        weight_mask = torch.as_tensor(weight_mask, dtype=torch.float32, device=dev)
        if tuple(weight_mask.shape) != (H, W):
            raise ValueError(f"weight_mask has shape {tuple(weight_mask.shape)}, not {(H, W)}")

    # the run's block, built once per stage (a resumed process builds its own)
    if n_islands > 1:
        from ..parallel import island

        run = island.make_run_block(obj, ga, gnm, n_islands, migrate_every, migrate_k, sig_max,
                                    sig_min, mesh=mesh)
    elif memetic_every > 0:
        run = make_memetic_run_block(obj, ga, gnm, GradConfig(lr=memetic_lr), memetic_every,
                                     memetic_steps, sig_max, sig_min)
    else:
        run = make_run_block(obj, ga, gnm, sig_max, sig_min)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    state = init(rng, obj, target, weight_mask, ga, gnm, init_pop=init_pop)
    start_gen = 0
    curves = {
        "best": [float(state.best_fit)],
        "mean": [float(torch.mean(state.fits))],
        "median": [float(_median(state.fits))],
    }
    if resume_from:
        # the template drew from a fresh generator; the loaded state carries
        # the saved generator state and continues its stream
        state, meta = ckpt_mod.load_checkpoint(resume_from, state)
        start_gen = int(meta.get("gen", 0))
        curves = meta.get("curves", curves)

    pad = len(str(ga.generations))
    # every rank keeps the same blocks (the frame cadence shrinks them);
    # rank 0 alone writes the frames
    write_frames = save_video and main
    if write_frames and start_gen == 0:
        io_mod.save_frame_png(0, state.best, pad, prefix, video_dir, H, W, obj.k_sigma,
                              impl=obj.impl)
    radius = anneal_mod.default_radius(anneal_sigma0)
    cur_sigma, sigma_t, cur_target = 0.0, None, target

    # frames and recycles happen between blocks: a cadence finer than the
    # logging cadence shrinks the block (ga.py:467-472)
    block_size = min(log_every, frame_every) if save_video else log_every
    if recycle_every and recycle_k:
        block_size = min(block_size, recycle_every)
    block_size = max(1, block_size)
    gen = start_gen
    last_frame_bucket = gen // max(1, frame_every)
    profiled = not profile_dir
    try:
        while gen < ga.generations:
            block = min(block_size, ga.generations - gen)
            stepped = anneal_sigma0 > 0.0 and anneal_mod.sigma_step(
                gen, ga.generations, anneal_sigma0, anneal_frac, cur_sigma, target, radius)
            if stepped:
                cur_sigma, sigma_t, cur_target = stepped
                state = _rescore(state, obj, cur_target, weight_mask, sigma_t)
            t_block = time.perf_counter()
            # the first block after the starting one is traced (the first
            # builds the kernels)
            traced = not profiled and gen > start_gen and main
            profiled = profiled or traced
            with profiling.trace(profile_dir if traced else None), \
                    profiling.named_scope(f"{prefix} block {gen}-{gen + block}"):
                # the island and memetic blocks refuse annealing: sigma_t is None there
                kw = {} if sigma_t is None else {"blur_sigma": sigma_t}
                state, metrics = run(state, cur_target, weight_mask, block, **kw)
                metrics = metrics.cpu().numpy()  # the block's one host sync
            gens_per_s = block / max(1e-9, time.perf_counter() - t_block)
            curves["best"].extend(metrics[:, 0].tolist())
            curves["mean"].extend(metrics[:, 1].tolist())
            curves["median"].extend(metrics[:, 2].tolist())
            no_improve_now = int(metrics[-1, 3])
            gen += block

            if write_frames and gen // max(1, frame_every) > last_frame_bucket:
                last_frame_bucket = gen // max(1, frame_every)
                io_mod.save_frame_png(gen, state.best, pad, prefix, video_dir, H, W,
                                      obj.k_sigma, impl=obj.impl)
            periodic = bool(recycle_every and recycle_k and gen % recycle_every < block
                            and gen < ga.generations)
            stalled = bool(recycle_patience and recycle_k and gen < ga.generations
                           and no_improve_now >= recycle_patience)
            if periodic or stalled:
                # placed and scored on the current (blurred) landscape; the
                # draws are seeded by (seed, gen), as fold_in(seed ^ 0x5EED, gen)
                r_rng = torch.Generator(device=dev).manual_seed(((seed ^ 0x5EED) << 32) + gen)
                new_pop = grow.recycle_population(state.pop, recycle_k, cur_target, obj,
                                                  weight_mask, rng=r_rng)
                eval_pop = (new_pop if sigma_t is None
                            else anneal_mod.blur_genome_axes(new_pop, sigma_t))
                state = state._replace(
                    pop=new_pop, fits=_evaluate(obj, eval_pop, cur_target, weight_mask))
                if stalled:
                    state = state._replace(no_improve=torch.zeros_like(state.no_improve))
                    no_improve_now = 0
            if checkpoint_path and checkpoint_every and gen % checkpoint_every < block:
                ckpt_mod.save_checkpoint_distributed(checkpoint_path, state,
                                                     meta={"gen": gen, "curves": curves},
                                                     mesh=mesh)
            if main and (gen % max(1, log_every) < block or gen >= ga.generations):
                print(
                    f"{prefix} gen {gen}/{ga.generations} best {metrics[-1, 0]:.6f} "
                    f"stale {no_improve_now} sigma {cur_sigma:.3g} {gens_per_s:.1f} gen/s",
                    flush=True,
                )
            # a stage that has not improved its best for stall_patience
            # generations ends, so the caller can grow capacity
            if stall_patience and no_improve_now >= stall_patience:
                break
    except KeyboardInterrupt:
        print("\n[Interrupted] Returning current best individual…", flush=True)

    try:
        if main:
            curves_mod.save_loss_curve_png(
                curves, loss_png_path, title=f"{prefix} fitness", xlabel="Generation",
                ylabel="MSE", log_y=True,
            )
            curves_mod.save_curves_csv(curves, loss_csv_path)
    except Exception as e:  # a plot must not lose the run's result
        print(f"[warn] Could not save loss curves: {e}")

    io_mod.flush_frames()
    best = state.best.cpu().numpy()
    if return_state:
        return best, float(state.best_fit), curves, state.pop.cpu().numpy()
    return best, float(state.best_fit), curves
