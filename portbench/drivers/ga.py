"""GA cells: the block loop of ga.genetic_approx, without frames, curves or
checkpoints.

Set-up: the program's state from the seed (ga.init: its population and
first evaluation), its run block (ga.make_run_block), and `warm_blocks`
blocks (the first runs eagerly and is captured as a CUDA graph, the
second replays it; a chunked evaluate stays eager). The window replays
whole blocks of `block` generations, each read back to the host as the
runner does. A traced run profiles `trace_blocks` blocks instead.

The check, once the window has closed and the peak memory is read: the
fits of a sample of the first population, of the population the window
ends with and of the one a further block makes (drawn from the seed, as
many from each evaluation chunk's offspring where the objective scores
in chunks), and each best, against
the reference's energies of the same genomes; and the further block's
population, which may keep at most elite_k genomes of the one before it
(every offspring is mutated), so a block that returns its state unchanged
shows.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness, inputs, reference, roofline
from .. import trace as trace_mod


def _sample(state, idx: np.ndarray) -> tuple:
    """(genomes, fits) of rows idx and of the best, cloned."""
    i = torch.as_tensor(idx, device=state.pop.device)
    g = torch.cat([state.pop[i], state.best[None]]).clone()
    f = torch.cat([state.fits[i], state.best_fit.reshape(1)]).clone()
    return g, f


def _strata(P: int, chunk, elites: int) -> list:
    """Row ranges that the check draws from evenly: the whole population,
    or, where the objective scores in chunks, the rows of each chunk's
    offspring (a population is its elites, then the offspring in order)."""
    if not chunk or chunk >= P:
        return [(0, P)]
    return [(elites + lo, min(P, elites + lo + chunk)) for lo in range(0, P - elites, chunk)]


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: bool = False, t_start: float = None):
    from ggs_tpu_torch.config import GAConfig, GenomeConfig, MaskConfig
    from ggs_tpu_torch.models import ga
    from ggs_tpu_torch.ops import mask as mask_mod
    from ggs_tpu_torch.ops import objective

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, tr, lim = cell.config, cell.traffic, cell.limits
    dev = torch.device(device)
    H, W, N = cfg["height"], cfg["width"], cfg["n_splats"]
    P, block = tr["pop_size"], tr["block"]
    target = torch.from_numpy(inputs.target(cfg)).to(dev)
    mask_kw = dict(cfg["mask"], edge_scales=tuple(cfg["mask"]["edge_scales"]))
    wm = mask_mod.mask_from_config(target, H, W, MaskConfig(**mask_kw))
    obj = objective.Objective(
        H=H, W=W, k_sigma=cfg["k_sigma"], metric=cfg["metric"], chunk=tr.get("eval_chunk"),
        precision="bf16" if control else cfg["precision"])
    gcfg = GAConfig(pop_size=P, **cfg["ga"])
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    state = ga.init(rng, obj, target, wm, gcfg, GenomeConfig(n_splats=N))
    pick = np.random.default_rng(seed)
    elites = max(1, min(gcfg.elite_k, P - 1))  # ga.step's elite count
    strata = _strata(P, tr.get("eval_chunk"), elites)
    k = min(P, tr["check_samples"]) // len(strata)

    def sample(st):
        return _sample(st, np.sort(np.concatenate([lo + pick.choice(hi - lo, k, replace=False)
                                                   for lo, hi in strata])))

    samples = [sample(state)]
    run_block = ga.make_run_block(obj, gcfg, GenomeConfig(n_splats=N))
    holder = [state]

    def one_block():
        st, m = run_block(holder[0], target, wm, block)
        m.cpu()  # the block's one read-back, as the runner's
        holder[0] = st

    for _ in range(tr["warm_blocks"]):
        one_block()
    harness.sync(dev)
    setup_s = time.perf_counter() - t_start
    rec = harness.record(kind="ga", setup_s=setup_s, H=H, W=W, n_splats=N, pop_size=P)
    if trace:
        graph = run_block.graphs.last if run_block.use_graphs else None
        nodes = (sum(graph.nodes[x] for x in ("KERNEL", "MEMCPY", "MEMSET"))
                 if graph is not None else None)
        span_table = (lambda: run_block.graphs.last.spans) if graph is not None else None
        nb = tr["trace_blocks"]
        reading = trace_mod.profile(
            lambda: [one_block() for _ in range(nb)], nb * nodes if nodes else None,
            trace_mod.load_table(),
            lambda: roofline.pair_counts(holder[0].pop, H, W, tr["count_tile_h"]), span_table)
        pre, post = reading["measured"]
        gens = nb * block
        reading.update(
            units=gens, renders=gens * P,
            nodes_per_unit=nodes / block if nodes else reading["ops"] / gens,
            # each generation walks P offspring of the population: the mean
            # of the population's counts before and after the traced blocks
            pair_px=gens * 0.5 * (pre[0] + post[0]),
            pair_cols=gens * 0.5 * (pre[1] + post[1]))
        rec.trace = reading
        attempted = gens * P * reading["attempts"]
    else:
        units, secs, nblocks = harness.timed_window(one_block, block * P, seconds)
        rec.window = {"units": units, "seconds": secs, "blocks": nblocks}
        rec.best_mse_end = float(holder[0].best_fit)
        attempted = units
    dev_info = harness.device_info(dev, cell.chips)

    # the check: the program's state is read, then freed, before the reference runs
    end = holder[0]
    samples.append(sample(end))
    before_fp = harness.fingerprints(end.pop)
    one_block()
    nxt = holder[0]
    samples.append(sample(nxt))
    kept = int(np.isin(harness.fingerprints(nxt.pop).numpy(), before_fp.numpy()).sum())
    repeats = max(0, kept - elites)
    del state, end, nxt, holder[:], run_block
    harness.free_cache(dev)

    mask = reference.importance_mask(target, H, W, **cfg["mask"])
    g = torch.cat([s[0] for s in samples])
    fits = torch.cat([s[1] for s in samples])
    ref = reference.energies(g, target, mask, H, W, cfg["k_sigma"])
    checks = [harness.check("fit_gap", harness.rel_gap(fits, ref), lim["fit_gap"]),
              harness.check("repeats", repeats, lim["repeats"])]
    return rec, checks, dev_info, attempted
