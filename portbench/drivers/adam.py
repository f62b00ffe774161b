"""Adam cells: the block loop of gradient.fit_adam.

Set-up: the program's genome (genome.new_population, as fit_adam draws
it, from the traffic's `splat_seed`, its splats put in an order drawn
from the seed), its run block (gradient.make_run_block) and state
(gradient.init_state), the first three steps as three one-step calls of
that block (the first eager, making Adam's moments; the second captured;
the third replayed), then `warm_blocks` blocks of `block` steps (captured,
then replayed). The window replays whole blocks, each read back to the
host as the runner does. A traced run profiles `trace_blocks` blocks.

The check, once the window has closed and the peak memory is read. The
start: the reference follows the first three steps from the same genome
and fresh moments (each step's energy, the first gradient as Adam holds
it, its first moment over 1 - beta1, and the genome's change over the
three steps, by gene column). The window's own block: from the state the
window ends with (genome, both moments), the block's graph is replayed
once more; the reference follows its first three steps from that state
at the step count the harness has counted, and holds the block's first
three energies (the first is best_mse_end) to its own. Inside one graph
the genome after a step is not to be seen, so the program's eager block
is run from the same state, one step, two steps and the rest: the first
step's gradient as Adam takes it ((exp_avg - beta1 * the moment before) /
(1 - beta1)) and the change over three steps are held to the reference's,
and the graph's energies and the genome, moments and step count it
leaves to the eager block's, which a replay equals bit for bit. The
control puts the reference in bfloat16 in the program's place.
"""
from __future__ import annotations

import time

import torch

from .. import harness, inputs, reference, roofline
from .. import trace as trace_mod


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: bool = False, t_start: float = None):
    from ggs_tpu_torch.config import GenomeConfig, GradConfig, MaskConfig
    from ggs_tpu_torch.models import genome, gradient
    from ggs_tpu_torch.ops import mask as mask_mod
    from ggs_tpu_torch.ops import objective

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, tr, lim = cell.config, cell.traffic, cell.limits
    dev = torch.device(device)
    H, W, N = cfg["height"], cfg["width"], cfg["n_splats"]
    block = tr["block"]
    target = torch.from_numpy(inputs.target(cfg)).to(dev)
    mask_kw = dict(cfg["mask"], edge_scales=tuple(cfg["mask"]["edge_scales"]))
    wm = mask_mod.mask_from_config(target, H, W, MaskConfig(**mask_kw))
    obj = objective.Objective(H=H, W=W, k_sigma=cfg["k_sigma"], metric=cfg["metric"],
                              precision=cfg["precision"])
    gnm = GenomeConfig(n_splats=N)
    gcfg = GradConfig(lr=tr["lr"])
    # the splats are drawn once, from the traffic's seed; --seed orders
    # them (their painter's order), so every seed starts from the same sizes
    gen = torch.Generator(device=dev).manual_seed(tr["splat_seed"])
    g0 = genome.new_population(gen, 1, N, H, W, gnm.min_scale, gnm.max_scale, device=dev)
    order = torch.Generator(device=dev).manual_seed(seed)
    g0 = g0[:, torch.randperm(N, generator=order, device=dev)].contiguous()
    run_block = gradient.make_run_block(obj, gnm, gcfg)
    holder = [gradient.init_state(run_block.make_opt, g0)]
    done = [0]  # steps taken, as the harness counts them

    def steps(n, call=None):
        st, fits = (call or run_block)(holder[0], target, wm, n)
        holder[0] = st
        done[0] += n
        return fits.min(dim=1).values.cpu()  # the block's one read-back, as the runner's

    def adam_state():
        """Clones of the genome, both moments and the step count."""
        st = holder[0].opt.state[holder[0].g]
        return [holder[0].g.detach().clone()] + [
            st[k].detach().clone() for k in ("exp_avg", "exp_avg_sq", "step")]

    first = [float(steps(1)[0])]
    moment1 = holder[0].opt.state[holder[0].g]["exp_avg"].clone()
    first += [float(steps(1)[0]), float(steps(1)[0])]
    g3 = holder[0].g.detach().clone()
    for _ in range(tr["warm_blocks"]):
        steps(block)
    harness.sync(dev)
    setup_s = time.perf_counter() - t_start
    rec = harness.record(kind="adam", setup_s=setup_s, H=H, W=W, n_splats=N)
    if trace:
        graph = run_block.graphs.last if run_block.use_graphs else None
        nodes = (sum(graph.nodes[x] for x in ("KERNEL", "MEMCPY", "MEMSET"))
                 if graph is not None else None)
        span_table = (lambda: run_block.graphs.last.spans) if graph is not None else None
        nb = tr["trace_blocks"]
        reading = trace_mod.profile(
            lambda: [steps(block) for _ in range(nb)], nb * nodes if nodes else None,
            trace_mod.load_table(),
            lambda: roofline.pair_counts(holder[0].g.detach(), H, W, tr["count_tile_h"]),
            span_table)
        pre, post = reading["measured"]
        reading.update(units=nb * block,
                       nodes_per_unit=nodes / block if nodes else reading["ops"] / (nb * block),
                       pair_px=nb * block * 0.5 * (pre[0] + post[0]),
                       pair_cols=nb * block * 0.5 * (pre[1] + post[1]))
        rec.trace = reading
        attempted = nb * block * reading["attempts"]
    else:
        units, secs, nblocks = harness.timed_window(lambda: steps(block), block, seconds)
        rec.window = {"units": units, "seconds": secs, "blocks": nblocks}
        attempted = units
    dev_info = harness.device_info(dev, cell.chips)

    # the window's own graph, once more, from the state the window ends with
    s_end, t_end = adam_state(), done[0]
    e_graph = steps(block)
    after_graph = adam_state()
    # the program's eager block from the same state: 1 step, 2, the rest
    for x, v in zip(gradient._adam_tensors(holder[0]).values(), s_end):
        x.copy_(v)
    e_eager = [steps(1, run_block.eager)]
    moment_end1 = holder[0].opt.state[holder[0].g]["exp_avg"].clone()
    e_eager.append(steps(2, run_block.eager))
    g3_end = holder[0].g.detach().clone()
    if block > 3:
        e_eager.append(steps(block - 3, run_block.eager))
    after_eager = adam_state()
    eager_gap = max(harness.max_rel_diff(a, b) for a, b in
                    zip([e_graph] + after_graph, [torch.cat(e_eager)] + after_eager))
    if not trace:
        rec.best_mse_end = float(e_graph[0])
    b1 = holder[0].opt.param_groups[0]["betas"][0]
    grad1 = moment1 / (1.0 - b1)
    grad_end = (moment_end1.double() - b1 * s_end[1].double()) / (1.0 - b1)
    del holder[:], run_block
    harness.free_cache(dev)

    mask = reference.importance_mask(target, H, W, **cfg["mask"])
    ks, lr = cfg["k_sigma"], tr["lr"]
    losses, grad1_ref, g3_ref = reference.follow_adam(g0[0], target, mask, H, W, 3, lr, k_sigma=ks)
    end = dict(moments=(s_end[1], s_end[2]), t0=t_end, k_sigma=ks)
    losses_end, grad_end_ref, g3_end_ref = reference.follow_adam(s_end[0][0], target, mask, H, W,
                                                                 3, lr, **end)
    block_first = [float(x) for x in e_graph[:3]]
    if control:
        bf = torch.bfloat16
        first, grad1, g3 = reference.follow_adam(g0[0], target, mask, H, W, 3, lr, k_sigma=ks,
                                                 dtype=bf)
        block_first, grad_end, g3_end = reference.follow_adam(s_end[0][0], target, mask, H, W, 3,
                                                              lr, dtype=bf, **end)

    def moved(grad_ref):
        """Columns that the gradient moves beyond rounding."""
        rn = grad_ref.reshape(-1, 9).double().norm(dim=0)
        return rn >= 1e-3 * rn.median()

    checks = [
        harness.check("loss_gap", harness.rel_gap(first, losses), lim["loss_gap"]),
        harness.check("grad_gap", harness.column_gap(grad1, grad1_ref), lim["grad_gap"]),
        harness.check("change_gap", harness.column_gap(g3 - g0, g3_ref - g0[0], moved(grad1_ref)),
                      lim["change_gap"]),
        harness.check("block_loss_gap", harness.rel_gap(block_first, losses_end),
                      lim["block_loss_gap"]),
        harness.check("end_grad_gap", harness.column_gap(grad_end, grad_end_ref),
                      lim["end_grad_gap"]),
        harness.check("block_change_gap",
                      harness.column_gap(g3_end - s_end[0], g3_end_ref - s_end[0][0],
                                         moved(grad_end_ref)), lim["block_change_gap"]),
        harness.check("block_eager_gap", eager_gap, lim["block_eager_gap"]),
    ]
    return rec, checks, dev_info, attempted
