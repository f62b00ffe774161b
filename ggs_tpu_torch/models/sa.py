"""Simulated annealing on the device (ggs_tpu/models/sa.py).

Two proposal modes (modules/annealing.py:48-190):
* "batched" (the default): all `tries_per_iter` mutants are proposed from
  the iteration-start state, scored in one `objective.evaluate` (one K1
  launch at exact-tight), and Metropolis-accepted in order.
* "sequential": each try mutates the possibly-updated state and is scored
  alone (batch-1 renders), the reference's exact chaining.
Temperature schedules, the 1e-12 best epsilon and the [best, current]
metrics row are the JAX package's (sa.py:84-107).

`lax.scan` becomes a Python loop: `run_block` keeps every value on the
device (acceptance by torch.where on 0-d tensors, the temperature a 0-d
device tensor), so the caller syncs once per block when it reads the
metrics; `make_run_block`, JAX's jitted block, captures that loop into a
CUDA graph once and replays it (utils/block_graph.py). A block's sigmas
and temperatures are read on the card from a table of the whole run
(genome.StepRows), as JAX computes them from its traced `it`. A step takes
its random numbers from the state's torch.Generator, or from `draws` when
given (the tests hand it the JAX package's own draws).
`simulated_annealing(replicas=K>1)` runs parallel tempering (models/pt.py);
it also writes video frames and checkpoints, and resumes from them.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import GenomeConfig, MaskConfig, MutSigma, SAConfig
from ..ops import mask as mask_mod
from ..ops import objective as objective_mod
from ..ops.objective import Objective
from . import genome as genome_mod
from . import operators


class SAState(NamedTuple):
    curr: torch.Tensor  # [N, 9]
    curr_fit: torch.Tensor  # scalar f32
    best: torch.Tensor  # [N, 9]
    best_fit: torch.Tensor  # scalar f32
    rng: torch.Generator  # on the state's device
    it: int


def _evaluate(obj, g, target, weight_mask):
    return objective_mod.evaluate(obj, g, target, weight_mask, device=g.device)


def init(
    rng: torch.Generator,
    obj: Objective,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor],
    gnm: GenomeConfig,
) -> SAState:
    """A fresh individual on rng's device and its energy."""
    curr = genome_mod.new_population(
        rng, 1, gnm.n_splats, obj.H, obj.W, gnm.min_scale, gnm.max_scale, device=rng.device
    )[0]
    fit = _evaluate(obj, curr[None], target, weight_mask)[0]
    return SAState(curr, fit, curr.clone(), fit.clone(), rng, 0)


def temperature(T, device=None) -> torch.Tensor:
    """max(T, 1e-30) in float32 as a 0-d tensor on `device`, made by a fill
    (no copy to the card); T a [1] device row (a temp_table's entry, read on
    the card) is clamped there. A tensor, not a Python float: the card
    divides by a CPU scalar as a multiply by its reciprocal, which rounds
    differently."""
    if torch.is_tensor(T):
        return torch.clamp_min(T, 1e-30).reshape(())
    t = np.maximum(np.float32(T), np.float32(1e-30))
    return torch.full((), float(t), dtype=torch.float32, device=device)


def _metropolis(u, curr, curr_fit, prop, prop_fit, T):
    """One accept/reject (modules/annealing.py:133-146): downhill always,
    uphill when u < exp(-dE / T). T is temperature()'s 0-d tensor; PT
    passes a [K] vector of chains (genomes [K, N, 9]) and its temperatures."""
    dE = prop_fit - curr_fit
    accept = (dE <= 0.0) | (u < torch.exp(-dE / T))
    new_curr = torch.where(accept[..., None, None], prop, curr)
    new_fit = torch.where(accept, prop_fit, curr_fit)
    return new_curr, new_fit, accept


def _keep_best(curr, curr_fit, best, best_fit):
    """The best so far, replaced when curr beats it by more than 1e-12
    (annealing.py:148)."""
    improved = curr_fit + 1e-12 < best_fit
    return torch.where(improved, curr, best), torch.where(improved, curr_fit, best_fit)


def draw_step(rng: torch.Generator, tries: int, N: int, device) -> Dict:
    """Every random number of one SA iteration, in both modes: `mut`, one
    mutation of a [tries, N, 9] batch (in "sequential" try t takes row t as
    its batch-1 draw), and `u_acc` [tries], the acceptance uniforms."""
    return {
        "mut": operators.draw_mutation(rng, tries, N, device),
        "u_acc": torch.rand((tries,), generator=rng, device=device),
    }


def step(
    state: SAState,
    obj: Objective,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor],
    sa: SAConfig,
    gnm: GenomeConfig,
    sig_max: dict,
    sig_min: dict,
    draws: Optional[Dict] = None,
    rows: Optional[genome_mod.StepRows] = None,
) -> Tuple[SAState, torch.Tensor]:
    """One SA iteration (= tries_per_iter proposals). Returns (state, [best, current]).
    With `rows` (step_table's StepRows, its counter holding state.it) the
    sigmas and temperature are the table's row, read on the device, and the
    counter advances; else they are computed on the host."""
    it = state.it
    dev = state.curr.device
    N = state.curr.shape[0]
    tries = sa.tries_per_iter
    if rows is None:
        T = temperature(genome_mod.temp_schedule(sa.temp_schedule, sa.t0, it, sa.iterations), dev)
        sig = genome_mod.build_mut_sigma(it, sa.iterations, sa.sigma_schedule, sig_max, sig_min)
    else:
        row = rows.row()
        rows.advance()
        sig, T = row[:, :8], temperature(row[:, 8])
    if draws is None:
        draws = draw_step(state.rng, tries, N, dev)
    u_acc = draws["u_acc"]

    def mutate(pop, mut):
        return operators.apply_mutation(
            pop, mut, sig, sa.mutpb, obj.H, obj.W, gnm.min_scale, gnm.max_scale
        )

    curr, curr_fit, best, best_fit = state.curr, state.curr_fit, state.best, state.best_fit
    if sa.proposal_mode == "batched":
        # all proposals from the iteration-start state; one batched score
        props = mutate(curr[None].expand(tries, N, 9), draws["mut"])
        prop_fits = _evaluate(obj, props, target, weight_mask)
        for t in range(tries):
            curr, curr_fit, _ = _metropolis(u_acc[t], curr, curr_fit, props[t], prop_fits[t], T)
            best, best_fit = _keep_best(curr, curr_fit, best, best_fit)
    elif sa.proposal_mode == "sequential":
        # each proposal mutates the updated state (annealing.py:121-146)
        for t in range(tries):
            prop = mutate(curr[None], {k: v[t : t + 1] for k, v in draws["mut"].items()})
            e_new = _evaluate(obj, prop, target, weight_mask)[0]
            curr, curr_fit, _ = _metropolis(u_acc[t], curr, curr_fit, prop[0], e_new, T)
            best, best_fit = _keep_best(curr, curr_fit, best, best_fit)
    else:
        raise ValueError(f"unknown proposal_mode: {sa.proposal_mode!r}")

    new_state = SAState(curr, curr_fit, best, best_fit, state.rng, it + 1)
    return new_state, torch.stack([best_fit, curr_fit])


def step_table(sa: SAConfig, sig_max: dict, sig_min: dict, rows: int = 0,
               ratio: bool = False) -> np.ndarray:
    """[rows, 9] float32 (rows defaults to sa.iterations + 1): iteration i's
    mutation sigmas (genome.mut_sigma_table) and its temperature
    (genome.temp_table), or with `ratio` PT's ladder factor, the
    temperature over f32(t0) (pt.step)."""
    sig = genome_mod.mut_sigma_table(sa.iterations, sa.sigma_schedule, sig_max, sig_min, rows)
    t = genome_mod.temp_table(sa.temp_schedule, sa.t0, sa.iterations, rows)
    if ratio:
        t = t / np.float32(sa.t0)
    return np.concatenate([sig, t[:, None]], axis=1)


def run_block(step_fn, obj, sa, gnm, sig_max=None, sig_min=None, ratio: bool = False):
    """-> run(state, target, weight_mask, num_iters) -> (state, metrics
    [num_iters, 2]): num_iters calls of step_fn (this module's step or
    PT's, `ratio` for PT's table) without a host sync, the sigmas and
    temperatures read on the device from step_table (uploaded once, its
    counter filled from state.it before the block). run.prepare(state, n)
    does that filling (and returns the StepRows) and run.loop(state,
    target, weight_mask, n) the steps: make_run_block's eager body."""
    sig_max_d = (sig_max or MutSigma.max_defaults()).__dict__
    sig_min_d = (sig_min or MutSigma.min_defaults()).__dict__
    tables: Dict[str, genome_mod.StepRows] = {}

    def prepare(state, num_iters: int) -> genome_mod.StepRows:
        dev = str(state.best.device)
        if dev not in tables:
            tables[dev] = genome_mod.StepRows(
                lambda r: step_table(sa, sig_max_d, sig_min_d, r, ratio), sa.iterations + 1,
                state.best.device)
        tables[dev].cover(state.it + num_iters)
        tables[dev].start(state.it)
        return tables[dev]

    def loop(state, target, weight_mask, num_iters: int):
        rows = tables[str(state.best.device)]
        out = []
        for _ in range(num_iters):
            state, m = step_fn(state, obj, target, weight_mask, sa, gnm, sig_max_d, sig_min_d,
                               rows=rows)
            out.append(m)
        return state, torch.stack(out)

    def run(state, target, weight_mask, num_iters: int):
        prepare(state, num_iters)
        return loop(state, target, weight_mask, num_iters)

    run.prepare, run.loop = prepare, loop
    return run


def graph_blocks(obj, eager, state_type, phase=lambda it: ()):
    """The run of make_run_block: `eager` (run_block's run) captured as a
    CUDA graph per (length, phase(state.it), shapes, generator) and replayed
    (utils/block_graph.py; on the CPU the eager loop), or `eager` itself
    where obj's blocks stay eager (block_graph.stays_eager). The state is donated:
    read the returned state and metrics before the next call and never
    reuse a state passed in. A block_graph.RunBlock: `run.eager` is the
    eager block (chip_smoke holds replays to it), run.prepare and run.loop
    its two parts (see run_block), `run.graphs` the BlockGraphs."""
    from ..utils.block_graph import BlockGraphs, RunBlock, stays_eager

    fields = [f for f in state_type._fields if f not in ("rng", "it")]

    def body(inp, n, it0, rng):
        st = state_type(*(inp[f] for f in fields), rng, it0)
        st, metrics = eager.loop(st, inp["target"], inp["weight_mask"], n)
        return tuple(getattr(st, f) for f in fields), metrics

    graphs = BlockGraphs(body)

    def graphed(state, target, weight_mask, num_iters: int):
        rows = eager.prepare(state, num_iters)
        inp = {f: getattr(state, f) for f in fields}
        inp.update(target=target, weight_mask=weight_mask)
        out, metrics = graphs(inp, num_iters, state.it, rng=state.rng, phase=phase(state.it),
                              epoch=rows.version)
        return state_type(*out, state.rng, state.it + num_iters), metrics

    return RunBlock(eager, graphed, graphs, eager.prepare, eager.loop, not stays_eager(obj))


def make_run_block(
    obj: Objective,
    sa: SAConfig,
    gnm: GenomeConfig,
    sig_max: Optional[MutSigma] = None,
    sig_min: Optional[MutSigma] = None,
):
    """-> run(state, target, weight_mask, num_iters) -> (state, metrics
    [num_iters, 2]): sa.make_run_block, SA steps replayed as a CUDA graph
    on a card (graph_blocks)."""
    return graph_blocks(obj, run_block(step, obj, sa, gnm, sig_max, sig_min), SAState)


def simulated_annealing(
    target_img,
    H: int,
    W: int,
    *,
    obj: Objective,
    sa: SAConfig,
    gnm: GenomeConfig,
    mask_cfg: Optional[MaskConfig] = None,
    sig_max: Optional[MutSigma] = None,
    sig_min: Optional[MutSigma] = None,
    seed: int = 42,
    log_every: int = 50,
    save_video: bool = False,
    frame_every: int = 10_000,
    video_dir: str = "",
    prefix: str = "sa",
    loss_png_path: str = "",
    loss_csv_path: str = "",
    loss_log_y: bool = False,
    replicas: int = 1,
    swap_every: int = 10,
    t_hot: float = 0.0,
    checkpoint_path: str = "",
    checkpoint_every: int = 0,
    resume_from: str = "",
    device="cuda",
):
    """Host loop: a full SA run with its curves (run_sags.py /
    annealing.py:48-190).

    replicas > 1 runs parallel tempering (models/pt.py): K chains on a
    geometric ladder from sa.t0 to t_hot (default 100 * t0), all proposals
    scored as one batch, neighbour swaps every `swap_every` iterations; the
    "current" curve then follows the coldest replica. The importance mask
    comes from every field of mask_cfg. `log_every` iterations run per
    block, with one host sync and one progress line each. save_video writes
    the best's frame every `frame_every` iterations to
    video_dir/{prefix}_{it}.png (the block shrinks to that cadence).
    checkpoint_every > 0 saves the state (SAState or PTState) with its
    iteration and curves to checkpoint_path after each block that crosses a
    multiple of it; resume_from continues such a run from its file, bit for
    bit (frames from iteration 0 are not written again).
    Returns (best genome [N, 9] np, best energy float, curves dict)."""
    from ..utils import checkpoint as ckpt_mod
    from ..utils import curves as curves_mod
    from ..utils import io as io_mod

    dev = resolve_device(device)
    mask_cfg = mask_cfg if mask_cfg is not None else MaskConfig()
    target = io_mod.ensure_hw(target_img, H, W, device=dev)
    weight_mask = mask_mod.mask_from_config(target, H, W, mask_cfg)

    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    if replicas > 1:
        from . import pt as pt_mod

        state = pt_mod.init(
            rng, obj, target, weight_mask, gnm, replicas,
            t_cold=sa.t0, t_hot=t_hot if t_hot > 0 else 100.0 * sa.t0,
        )
        run = pt_mod.make_run_block(obj, sa, gnm, sig_max, sig_min, swap_every)
    else:
        state = init(rng, obj, target, weight_mask, gnm)
        run = make_run_block(obj, sa, gnm, sig_max, sig_min)
    start_it = 0
    curves = {"best": [float(state.best_fit)], "current": [float(state.curr_fit)]}
    if resume_from:
        # the template drew from a fresh generator; the loaded state carries
        # the saved generator state and continues its stream
        state, meta = ckpt_mod.load_checkpoint(resume_from, state)
        start_it = int(meta.get("it", 0))
        curves = meta.get("curves", curves)

    pad = len(str(sa.iterations))
    if save_video and start_it == 0:
        io_mod.save_frame_png(0, state.best, pad, prefix, video_dir, H, W, obj.k_sigma,
                              impl=obj.impl)
    it = start_it
    last_frame_bucket = it // max(1, frame_every)
    block_size = max(1, min(log_every, frame_every) if save_video else log_every)
    try:
        while it < sa.iterations:
            block = min(block_size, sa.iterations - it)
            t_block = time.perf_counter()
            state, metrics = run(state, target, weight_mask, block)
            metrics = metrics.cpu().numpy()  # the block's one host sync
            its_per_s = block / max(1e-9, time.perf_counter() - t_block)
            curves["best"].extend(metrics[:, 0].tolist())
            curves["current"].extend(metrics[:, 1].tolist())
            it += block
            if save_video and it // max(1, frame_every) > last_frame_bucket:
                last_frame_bucket = it // max(1, frame_every)
                io_mod.save_frame_png(it, state.best, pad, prefix, video_dir, H, W, obj.k_sigma,
                                      impl=obj.impl)
            if checkpoint_path and checkpoint_every and it % checkpoint_every < block:
                ckpt_mod.save_checkpoint(checkpoint_path, state,
                                         meta={"it": it, "curves": curves})
            if it % max(1, log_every) < block or it >= sa.iterations:
                T = genome_mod.temp_schedule(sa.temp_schedule, sa.t0, it, sa.iterations)
                print(
                    f"it {it}/{sa.iterations} best {metrics[-1, 0]:.6f} "
                    f"curr {metrics[-1, 1]:.6f} T {T:.4g} {its_per_s:.1f} it/s",
                    flush=True,
                )
    except KeyboardInterrupt:
        print("\n[Interrupted] Returning current best…", flush=True)

    try:
        curves_mod.save_loss_curve_png(
            curves, loss_png_path, title=f"{prefix} energy ({obj.metric})", xlabel="Iteration",
            ylabel=obj.metric, log_y=loss_log_y,
        )
        curves_mod.save_curves_csv(curves, loss_csv_path)
    except Exception as e:  # a plot must not lose the run's result
        print(f"[warn] Could not save SA curves: {e}")

    io_mod.flush_frames()
    best = state.best.cpu().numpy()
    return best, float(state.best_fit), curves
