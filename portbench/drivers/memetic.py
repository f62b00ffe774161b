"""Memetic GA cells: the block loop of ga.genetic_approx with memetic_every
set (run_ga --memetic-every), without frames, curves or checkpoints.

Set-up: the program's state from the seed (ga.init), its memetic run block
(ga.make_memetic_run_block: every `every` generations the E elites take
`steps` Adam steps, gradient.make_refine, each kept only where the GA's
evaluator scores it lower), and `warm_blocks` blocks (the first runs
eagerly and is captured as a CUDA graph, the later ones replay it).
Every block starts at a generation that `every` divides, so the window
replays one graph. The window replays whole blocks, each read back to the
host as the runner does. A traced run profiles `trace_blocks` blocks
instead.

The check, once the window has closed and the peak memory is read:

* the GA's own, as portbench/drivers/ga.py makes it: `fit_gap` (the fits
  of a sample of the first population, of the population the window ends
  with and of the one the window's graph makes from it once more, and each
  best, against the reference's energies) and `repeats`;
* the refinement, from the state the first two warm blocks leave (a
  generation that `every` divides, early enough that the reference still
  keeps most refined elites; late in a run it keeps none, and a
  refinement that is never written back would read as one that is
  rejected). From that state, cloned with its generator's state, a
  plain GA block (ga.make_run_block, eager) of `every` generations gives
  A; the window's own block (the same object: its refine and that
  refine's Adam), eager for `every` generations from the same clone,
  gives B, which refines once, after its last step. B's rows after the
  elites equal A's in bits (`refine_rest_gap`). While B refines, the
  program's refined elites and their energies (the accept's
  objective.evaluate) and its first step's gradient (the fused route's)
  are read as they pass; B's elites, fits and best equal, in bits, what
  the accept's rule and the best's make of them and of A
  (`refine_accept_gap`); portbench/reference_memetic.py refines A's
  elites from A's fits, and the two are compared: the change by gene
  column (`refine_change_gap`), the first gradient of each elite's own
  energy (`refine_grad_gap`), the refined energies (`refine_fit_gap`)
  and the elites kept or not (`refine_kept_diff`: those decided
  otherwise than the reference decides, beyond a near tie);
* the window's graph, replayed once more from the end state, against
  ga.run_memetic_block run eagerly from the same state and generator
  (`block_eager_gap`: state, metrics and the generator's state).

The control runs every fitness of the program (the GA's and the
accept's) through its own bfloat16 walk (K1-bf16): the memetic block
differentiates its objective, which precision "bf16" refuses, so the
control reaches objective.evaluate instead of the Objective. It also puts
the reference's refinement computed in bfloat16 in the place of the
program's refined elites, their energies and first gradient, as the Adam
cells' control does. FAULTS are this driver's (portbench/control.py
--fault NAME).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import harness, inputs, reference, reference_memetic, roofline
from .. import trace as trace_mod
from .ga import _sample

REFINE = "ga.refine"  # the program's span and count of a refinement


def _clone(state, rng):
    """A GAState's tensors cloned, with the generator `rng`."""
    return state._replace(**{k: getattr(state, k).clone()
                             for k in ("pop", "fits", "best", "best_fit", "no_improve")}, rng=rng)


def _generator_at(state, dev):
    g = torch.Generator(device=dev)
    g.set_state(state)
    return g


@contextlib.contextmanager
def _seen_refining():
    """While a refinement (ga._refine) runs: the genomes the accept scores
    and its energies (objective.evaluate), and the first gradient the fused
    route returns, read as they pass (clones; the program is unchanged)."""
    from ggs_tpu_torch.models import ga
    from ggs_tpu_torch.ops import objective, render_grad

    seen, inside = {}, [False]
    real = {"refine": ga._refine, "evaluate": objective.evaluate,
            "fused": render_grad.fused_value_and_grad}

    def refine(*a, **k):
        inside[0] = True
        try:
            return real["refine"](*a, **k)
        finally:
            inside[0] = False

    def evaluate(obj, g, *a, **k):
        out = real["evaluate"](obj, g, *a, **k)
        if inside[0]:
            seen["refined"], seen["fits"] = g.detach().clone(), out.detach().clone()
        return out

    def fused(*a, **k):
        out = real["fused"](*a, **k)
        if inside[0] and "grad" not in seen:
            seen["grad"] = out[1].detach().clone()
        return out

    ga._refine, objective.evaluate, render_grad.fused_value_and_grad = refine, evaluate, fused
    try:
        yield seen
    finally:
        ga._refine, objective.evaluate = real["refine"], real["evaluate"]
        render_grad.fused_value_and_grad = real["fused"]


@contextlib.contextmanager
def _bf16_fitness(on: bool):
    """The control: objective.evaluate scores at precision "bf16"."""
    from ggs_tpu_torch.ops import objective

    real = objective.evaluate
    if on:
        objective.evaluate = lambda obj, *a, **k: real(obj._replace(precision="bf16"), *a, **k)
    try:
        yield
    finally:
        objective.evaluate = real


def _accept_gap(a, b, refined, new_fits, E: int) -> float:
    """B's elites, their fits and its best against what the accept makes of
    the refined elites and the energies the program scored them at (each
    kept where its energy is below the elite's fit) and of A, B's state
    before it refined (the best replaced on ga._refine's 1e-10 rule): 0
    where they are equal in bits."""
    better = new_fits < a.fits[:E]
    pop = torch.cat([torch.where(better[:, None, None], refined, a.pop[:E]), a.pop[E:]])
    fits = torch.cat([torch.where(better, new_fits, a.fits[:E]), a.fits[E:]])
    i = int(torch.argmin(fits))
    improved = bool(fits[i] + 1e-10 < a.best_fit)
    best, best_fit = (pop[i], fits[i]) if improved else (a.best, a.best_fit)
    stall = torch.zeros_like(a.no_improve) if improved else a.no_improve
    return max([harness.max_rel_diff(b.pop[:E], pop[:E]),
                harness.max_rel_diff(b.fits[:E], fits[:E]),
                harness.max_rel_diff(b.best, best), harness.max_rel_diff(b.best_fit, best_fit),
                float(not torch.equal(b.no_improve, stall))])


def _refines(gen0: int, gens: int, every: int) -> int:
    """The refinements in the generations gen0 + 1 .. gen0 + gens."""
    return (gen0 + gens) // every - gen0 // every


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: bool = False, t_start: float = None):
    with _bf16_fitness(control):
        return _run(cell, seed, seconds, trace, device, control, t_start)


def _run(cell, seed, seconds, trace, device, control, t_start):
    from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig, MaskConfig
    from ggs_tpu_torch.models import ga
    from ggs_tpu_torch.ops import mask as mask_mod
    from ggs_tpu_torch.ops import objective

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, tr, lim = cell.config, cell.traffic, cell.limits
    dev = torch.device(device)
    H, W, N = cfg["height"], cfg["width"], cfg["n_splats"]
    P, block = tr["pop_size"], tr["block"]
    every, steps, lr = (cfg["memetic"][k] for k in ("every", "steps", "lr"))
    if block % every:
        raise ValueError(f"a block of {block} generations does not start every block at a "
                         f"generation that {every} divides")
    target = torch.from_numpy(inputs.target(cfg)).to(dev)
    mask_kw = dict(cfg["mask"], edge_scales=tuple(cfg["mask"]["edge_scales"]))
    wm = mask_mod.mask_from_config(target, H, W, MaskConfig(**mask_kw))
    obj = objective.Objective(H=H, W=W, k_sigma=cfg["k_sigma"], metric=cfg["metric"],
                              precision=cfg["precision"])
    gcfg, gnm = GAConfig(pop_size=P, **cfg["ga"]), GenomeConfig(n_splats=N)
    grad = GradConfig(lr=lr)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    state = ga.init(rng, obj, target, wm, gcfg, gnm)
    pick = np.random.default_rng(seed)
    E = max(1, gcfg.elite_k)  # make_memetic_run_block's elites
    elites = max(1, min(gcfg.elite_k, P - 1))  # ga.step's
    k = min(P, tr["check_samples"])

    def sample(st):
        return _sample(st, np.sort(pick.choice(P, k, replace=False)))

    samples = [sample(state)]
    run_block = ga.make_memetic_run_block(obj, gcfg, gnm, grad, every, steps)
    holder = [state, None]

    def one_block():
        st, m = run_block(holder[0], target, wm, block)
        holder[1] = m.cpu()  # the block's one read-back, as the runner's
        holder[0] = st

    for i in range(tr["warm_blocks"]):
        one_block()
        if i == min(1, tr["warm_blocks"] - 1):
            # the refinement check starts from the state after the capture and
            # the first replay, where the reference still keeps most refined elites
            warm, at_warm = _clone(holder[0], None), holder[0].rng.get_state()
    harness.sync(dev)
    setup_s = time.perf_counter() - t_start
    rec = harness.record(kind="ga", setup_s=setup_s, H=H, W=W, n_splats=N, pop_size=P)
    if trace:
        graph = run_block.graphs.last if run_block.use_graphs else None
        nodes = (sum(graph.nodes[x] for x in ("KERNEL", "MEMCPY", "MEMSET"))
                 if graph is not None else None)
        span_table = (lambda: run_block.graphs.last.spans) if graph is not None else None
        nb = tr["trace_blocks"]

        def measure():
            pop = holder[0].pop
            return (roofline.pair_counts(pop, H, W, tr["count_tile_h"]),
                    roofline.pair_counts(pop[:E], H, W, tr["grad_count_tile_h"]),
                    roofline.pair_counts(pop[:E], H, W, tr["count_tile_h"]))

        gen0 = holder[0].gen
        reading = trace_mod.profile(lambda: [one_block() for _ in range(nb)],
                                    nb * nodes if nodes else None, trace_mod.load_table(),
                                    measure, span_table)
        (pre, pre_e, pre_a), (post, post_e, post_a) = reading["measured"]
        gens = nb * block
        refines = _refines(gen0, gens, every)
        walks = refines * steps  # K7 launches, each over the E elites
        reading.update(
            units=gens, renders=gens * P,
            nodes_per_unit=nodes / block if nodes else reading["ops"] / gens,
            pair_px=gens * 0.5 * (pre[0] + post[0]),
            pair_cols=gens * 0.5 * (pre[1] + post[1]),
            # each Adam step of a refinement walks the E elites: the mean of
            # their counts before and after the traced blocks
            grad_walks=walks * E,
            grad_pair_px=walks * 0.5 * (pre_e[0] + post_e[0]),
            grad_pair_cols=walks * 0.5 * (pre_e[1] + post_e[1]),
            # each accept scores the E refined elites with K1, as the GA scores
            # its offspring: counted as the elites before and after
            accepts=refines, accept_renders=refines * E,
            accept_pair_px=refines * 0.5 * (pre_a[0] + post_a[0]),
            accept_pair_cols=refines * 0.5 * (pre_a[1] + post_a[1]))
        # the program's own count of its refinements in one replay, and the
        # replayed nodes under its refinement span (None where it has neither)
        counted = graph.delta.get(REFINE, 0) if graph is not None else 0
        if counted and graph.spans is not None:
            inside = sum(REFINE in path.split("/") for path in graph.spans)
            if inside:
                reading["refine_nodes_per_refine"] = inside / counted
        rec.trace = reading
        attempted = gens * P * reading["attempts"]
    else:
        units, secs, nblocks = harness.timed_window(one_block, block * P, seconds)
        rec.window = {"units": units, "seconds": secs, "blocks": nblocks}
        rec.best_mse_end = float(holder[0].best_fit)
        attempted = units
    dev_info = harness.device_info(dev, cell.chips)

    # the check: the program's states are read, then freed, before the reference runs
    end = holder[0]
    samples.append(sample(end))
    before_fp = harness.fingerprints(end.pop)
    at_end = end.rng.get_state()
    start = _clone(end, None)
    # A: the plain GA; B: the window's own block, eager, refining once at its
    # end; both from the state the warm blocks left
    a, _ = ga.make_run_block(obj, gcfg, gnm).eager(
        _clone(warm, _generator_at(at_warm, dev)), target, wm, every)
    with _seen_refining() as seen:
        b, _ = run_block.eager(_clone(warm, _generator_at(at_warm, dev)), target, wm, every)
    rest_gap = max(harness.max_rel_diff(b.pop[E:], a.pop[E:]),
                   harness.max_rel_diff(b.fits[E:], a.fits[E:]))
    kept = (b.pop[:E] != a.pop[:E]).flatten(1).any(dim=1).cpu()
    # a refinement that scored nothing and took no gradient refined nothing
    refined = seen.get("refined", b.pop[:E])
    new_fits = seen.get("fits", b.fits[:E])
    grad1 = seen.get("grad", torch.zeros_like(refined)) * E  # of each elite's own energy
    elites_a, fits_a = a.pop[:E], a.fits[:E]
    accept_gap = _accept_gap(a, b, refined, new_fits, E)
    # the window's graph once more from the end state (its generator is still
    # there: A and B drew from their own), and the eager block
    one_block()
    nxt, m_graph = holder[0], holder[1]
    samples.append(sample(nxt))
    kept_fp = int(np.isin(harness.fingerprints(nxt.pop).numpy(), before_fp.numpy()).sum())
    repeats = max(0, kept_fp - elites)
    eager_rng = _generator_at(at_end, dev)
    c, m_eager = ga.run_memetic_block(_clone(start, eager_rng), obj, target, wm, gcfg, gnm, grad,
                                      every, steps, block)
    eager_gap = max([harness.max_rel_diff(getattr(nxt, f).float(), getattr(c, f).float())
                     for f in ("pop", "fits", "best", "best_fit", "no_improve")]
                    + [harness.max_rel_diff(m_graph, m_eager.cpu()),
                       float(not torch.equal(nxt.rng.get_state(), eager_rng.get_state()))])
    del state, end, nxt, a, b, c, start, warm, holder[:], run_block, seen
    harness.free_cache(dev)

    mask = reference.importance_mask(target, H, W, **cfg["mask"])
    g = torch.cat([s[0] for s in samples])
    fits = torch.cat([s[1] for s in samples])
    ref = reference.energies(g, target, mask, H, W, cfg["k_sigma"])
    r_refined, r_fits, r_kept, r_grad1 = reference_memetic.refine(
        elites_a, fits_a, target, mask, H, W, steps, lr, cfg["k_sigma"])
    if control:  # the reference in bfloat16 in the place of the program's refinement
        refined, new_fits, _, grad1 = reference_memetic.refine(
            elites_a, fits_a, target, mask, H, W, steps, lr, cfg["k_sigma"], dtype=torch.bfloat16)
    rn = r_grad1.reshape(-1, 9).double().norm(dim=0)
    moved = rn >= 1e-3 * rn.median()  # columns the gradient moves beyond rounding
    # decided otherwise than the reference, where its energy is no near tie with the fit
    apart = ((r_fits - fits_a.double()).abs() > lim["fit_gap"] * fits_a.double().abs()).cpu()
    checks = [
        harness.check("fit_gap", harness.rel_gap(fits, ref), lim["fit_gap"]),
        harness.check("repeats", repeats, lim["repeats"]),
        harness.check("refine_rest_gap", rest_gap, lim["refine_rest_gap"]),
        harness.check("refine_accept_gap", accept_gap, lim["refine_accept_gap"]),
        harness.check("refine_change_gap",
                      harness.column_gap(refined - elites_a, r_refined - elites_a, moved),
                      lim["refine_change_gap"]),
        harness.check("refine_grad_gap", harness.column_gap(grad1, r_grad1),
                      lim["refine_grad_gap"]),
        harness.check("refine_fit_gap", harness.rel_gap(new_fits, r_fits), lim["refine_fit_gap"]),
        harness.check("refine_kept_diff", int(((kept != r_kept.cpu()) & apart).sum()),
                      lim["refine_kept_diff"]),
        harness.check("block_eager_gap", eager_gap, lim["block_eager_gap"]),
    ]
    return rec, checks, dev_info, attempted


# ---------------------------------------------------------------- faults


def grad_altered(mp):
    """The fused route's gradient 0.1% high; its energies as they are."""
    from ggs_tpu_torch.ops import render_grad

    real = render_grad.fused_value_and_grad

    def altered(*a, **k):
        (loss, fits), grads = real(*a, **k)
        return (loss, fits), grads * (1 + 1e-3)

    mp.setattr(render_grad, "fused_value_and_grad", altered)


def _make_refine(reset: bool = True, keep: str = "lower"):
    """gradient.make_refine as the program builds it, with the moments and
    step count left as the last refinement left them (reset False), or a
    refined elite kept where it scores no lower (keep "higher") or never
    (keep "never": the accept always takes the elite it was given)."""
    from ggs_tpu_torch.models import gradient
    from ggs_tpu_torch.ops import objective

    def make_refine(obj, gnm, cfg, steps):
        make_opt, step = gradient.make_fit_step(obj, gnm, cfg)
        held = {}

        def refine(elites, elite_fits, target, weight_mask):
            key = (tuple(elites.shape), str(elites.device))
            state = held.get(key)
            if state is None:
                g = torch.empty(elites.shape, dtype=torch.float32, device=elites.device)
                state = held[key] = gradient.GradState(g, make_opt(g), 0)
            with torch.no_grad():
                state.g.copy_(elites)
            if reset:
                for t in state.opt.state.get(state.g, {}).values():
                    t.zero_()
            state, _ = gradient.run_block(state, step, target, weight_mask, steps)
            g = state.g.detach()
            new_fits = objective.evaluate(obj, g, target, weight_mask, device=elites.device)
            better = {"lower": new_fits < elite_fits, "higher": new_fits >= elite_fits,
                      "never": torch.zeros_like(elite_fits, dtype=torch.bool)}[keep]
            return (torch.where(better[:, None, None], g, elites),
                    torch.where(better, new_fits, elite_fits))

        return refine

    return make_refine


def refine_skipped(mp):
    """make_refine's refinement returns the elites and fits it was given."""
    from ggs_tpu_torch.models import gradient

    mp.setattr(gradient, "make_refine",
               lambda obj, gnm, cfg, steps: lambda elites, fits, target, wm: (elites, fits))


def stale_moments(mp):
    """The refinement's Adam keeps its moments and step count from the last
    refinement instead of starting them at zero."""
    from ggs_tpu_torch.models import gradient

    mp.setattr(gradient, "make_refine", _make_refine(reset=False))


def keeps_worse(mp):
    """The accept rule inverted: a refined elite is kept where it scores no
    lower."""
    from ggs_tpu_torch.models import gradient

    mp.setattr(gradient, "make_refine", _make_refine(keep="higher"))


def discards_refinement(mp):
    """The refinement runs and scores its elites, and the accept keeps none
    of them: the elites and fits it was given come back."""
    from ggs_tpu_torch.models import gradient

    mp.setattr(gradient, "make_refine", _make_refine(keep="never"))


def best_not_updated(mp):
    """The refined elites are written back, and the best and its stall count
    stay as the generation before the refinement left them."""
    from ggs_tpu_torch.models import ga

    real = ga._refine

    def refine(state, *a, **k):
        return real(state, *a, **k)._replace(best=state.best, best_fit=state.best_fit,
                                              no_improve=state.no_improve)

    mp.setattr(ga, "_refine", refine)


FAULTS = {"grad-altered": grad_altered, "refine-skipped": refine_skipped,
          "stale-moments": stale_moments, "keeps-worse": keeps_worse,
          "discards-refinement": discards_refinement, "best-not-updated": best_not_updated}
