"""Gradient-descent splat fitting and the memetic refinement of the GA.

PyTorch counterpart of `ggs_tpu/models/gradient.py`. The masked-MSE
objective is differentiable in the axes-angle genome through the tiled
renderer's exact backward (ops/render_grad.py), which gives:

* `fit_adam`: projected Adam on a genome batch; the projection is
  `codec.clamp_genome`, the domain the evolutionary operators keep.
* `refine_elites`: a few Adam steps on the GA's elites, each kept only when
  the GA's own evaluator scores it better (Lamarckian refinement);
  `make_refine` is the same built once, which the memetic block of
  models/ga.py holds and a CUDA graph replays.

Under precision "fast" the gradient paths walk the eps-culled lists
(`_grad_cull_eps`, `_grad_corner`): exact gradients of the culled render the
fast GA selects on. Metrics "ssim" and "mix" differentiate the canvases
through autograd (ops/ssim.py), so they take render_diff (K2' forward, K6
backward) and never the fused K7 path (gradient.py:242-246). `optax.adam`
becomes `torch.optim.Adam` with the same lr, betas and eps (the same update
up to rounding); the optimizer updates the state's genome tensor in place
and the projection follows under `torch.no_grad()`. The blur homotopy
(`blur_sigma`, `anneal_sigma0`; ops/anneal.py) scores the blurred genome on
the objective's usual path (K7 under "mse") and chains its gradient back to
the raw genome through the blur by autograd. Under `obj.mesh` the loss is
tile-sharded (`_make_sharded_loss_fn`, gradient.py:135-216): each rank
renders its row slab by render_diff (K2' forward, K6 backward; never the
fused K7, :247-249), the slab energies are summed over the tile group
(ops/objective.sharded_energy_rows) and the genome gradient is all-reduced
over it once after the backward; a batch that divides the pop axis is
split over it, any other (run_grad's single genome) runs replicated there.
`make_run_block` (JAX's jitted Adam block) replays `run_block` as a CUDA
graph on a card (utils/block_graph.py); there the Adam is torch.optim's
capturable fused one, whose step count and bias corrections live on the
card.
Precision "bf16" is a fitness-only tier and is refused here, as
runners/run_grad.py refuses it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..config import GenomeConfig, GradConfig
from ..ops import anneal as anneal_mod
from ..ops import codec, oracle, render_cuda, render_grad
from ..ops import objective as objective_mod
from ..ops.objective import Objective
from ..parallel import comm, shard
from ..utils import profiling
from . import genome as genome_mod


def _grad_cull_eps(obj: Objective) -> Optional[float]:
    """The eps cull of the differentiable tiled paths: obj.cull_eps (or the
    default) under precision "fast", else None (gradient.py:32-47)."""
    if obj.precision != "fast":
        return None
    return render_cuda._eps(obj.cull_eps)


def _grad_corner(obj: Objective) -> bool:
    """The corner cull of the differentiable tiled paths: on exactly when
    the fast evaluator's is (gradient.py:50-57)."""
    return bool(obj.corner_cull) and obj.precision == "fast"


def _grad_box(obj: Objective) -> str:
    """"tight" trains on the exact-tight tier's boxes, else the reference's
    (under "fast" the eps-tight boxes of _grad_cull_eps take their place)."""
    return "tight" if obj.precision == "exact-tight" else "reference"


def _check_objective(obj: Objective) -> None:
    objective_mod.check_metric(obj.metric)
    render_cuda._check_precision(obj.precision)
    if obj.precision == "bf16":
        raise NotImplementedError("precision 'bf16' is a fitness-only tier: no gradients")
    if obj.impl not in ("cuda", "oracle"):
        raise ValueError(f"unknown renderer impl: {obj.impl!r}")


def make_loss_fn(obj: Objective, gnm: GenomeConfig):
    """Differentiable loss: axes-angle genomes [B, N, 9] -> (mean energy,
    energies [B]) in obj's metric. impl "cuda" renders with
    render_grad.render_diff (forward K2, backward K6; eps-culled under
    "fast"); impl "oracle" with the dense renderer and autograd (always
    exact). Under obj.mesh (impl "cuda", shapes that divide it) the
    tile-sharded loss, whose fits are the whole batch's on every rank;
    its gradients come from make_value_and_grad."""
    _check_objective(obj)
    if obj.mesh is not None and obj.impl == "cuda":
        sharded = _make_sharded_loss_fn(obj)
        if sharded is not None:
            return sharded
    bg = tuple(float(c) for c in obj.background)

    def loss_fn(g_axes, target, weight_mask):
        g9 = codec.genome_to_renderer(g_axes)
        if obj.impl == "cuda":
            imgs = render_grad.render_diff(
                g9, obj.H, obj.W, k_sigma=obj.k_sigma, background=bg,
                bin_capacity=obj.bin_capacity, cull_eps=_grad_cull_eps(obj),
                corner_cull=_grad_corner(obj), box=_grad_box(obj),
            )
        else:
            imgs = oracle.render_dense(
                g9, obj.H, obj.W, k_sigma=obj.k_sigma, background=bg, box=_grad_box(obj)
            )
        fits = objective_mod.image_energy(obj, imgs, target, weight_mask)
        return torch.mean(fits), fits

    return loss_fn


def _make_sharded_local(obj: Objective):
    """-> local(g_axes [B, N, 9], target, weight_mask) -> (this rank's
    energies, the rows of g they score, split): the rank's pop rows of g
    when B divides the pop axis (split), else all of them, rendered on its
    row slab (render_diff with y_origin and out_rows) and scored by
    sharded_energy_rows, summed over the tile group by comm.psum. None
    where the canvas does not divide the mesh or a slab is shorter than the
    SSIM halo (gradient.py:168-171)."""
    if not objective_mod.sharded_metric_viable(obj):
        return None
    mesh = obj.mesh
    rows = shard.tile_rows(obj.H, mesh)
    bg = tuple(float(c) for c in obj.background)

    def local(g_axes, target, weight_mask):
        B = g_axes.shape[0]
        split = B % mesh.pop_shards == 0
        sel = shard.pop_rows(B, mesh) if split else slice(0, B)
        imgs = render_grad.render_diff(
            codec.genome_to_renderer(g_axes[sel]), obj.H, obj.W, k_sigma=obj.k_sigma,
            background=bg, bin_capacity=obj.bin_capacity, y_origin=rows.start,
            out_rows=rows.stop - rows.start, cull_eps=_grad_cull_eps(obj),
            corner_cull=_grad_corner(obj), box=_grad_box(obj),
        )
        fits = objective_mod.sharded_energy_rows(
            obj, imgs, shard.place_target(target, mesh), shard.place_mask(weight_mask, mesh),
            rows.start, mesh)
        return fits, sel, split

    return local


def _make_sharded_loss_fn(obj: Objective):
    """The tile-sharded loss over obj.mesh: (g_axes, target, weight_mask) ->
    (mean energy, energies [B]), the whole batch's on every rank (a split
    batch's energies gathered over the pop group). None where
    _make_sharded_local is (the caller then takes the unsharded loss)."""
    local = _make_sharded_local(obj)
    if local is None:
        return None

    def loss_fn(g_axes, target, weight_mask):
        fits, _, split = local(g_axes, target, weight_mask)
        if split:
            fits = comm.pop_gather(fits, obj.mesh)
        return torch.mean(fits), fits

    return loss_fn


def _sharded_value_and_grad(obj: Objective, local):
    """((loss, fits), grads) of the tile-sharded loss: each rank takes the
    gradient of its rows' share of the mean, sum(local fits) / B, whose
    psum passes the cotangent through unchanged; the genome gradient is then
    all-reduced over the tile group (the other slabs' shares) and, for a
    split batch, its rows and the fits gathered over the pop group."""
    mesh = obj.mesh

    def vg(g_axes, target, weight_mask):
        B = g_axes.shape[0]
        g = g_axes.detach().to(torch.float32).requires_grad_(True)
        with torch.enable_grad():
            fits, sel, split = local(g, target, weight_mask)
            (grads,) = torch.autograd.grad(torch.sum(fits) / float(B), g)
        grads = comm.tile_sum(grads[sel] if split else grads, mesh)
        fits = fits.detach()
        if split:
            grads = comm.pop_gather(grads, mesh)
            fits = comm.pop_gather(fits, mesh)
        return (torch.mean(fits), fits), grads

    return vg


def make_value_and_grad(obj: Objective, gnm: GenomeConfig):
    """(g_axes, target, weight_mask) -> ((loss, fits), grads [B, N, 9]).

    impl "cuda" with metric "mse" takes the fused path, one K7 launch per
    step (render_grad.fused_value_and_grad), up to render_cuda.MAX_SPLATS
    splats; above that, for metrics "ssim" and "mix" (K7's loss head is the
    weighted-SSE family only) and for impl "oracle", autograd through
    make_loss_fn (K2 and K6 once per chained pass; gradient.py:242-257).
    Under obj.mesh (impl "cuda") the tile-sharded loss and its gradient
    (K2' and K6 on each rank's slab, never K7)."""
    _check_objective(obj)
    if obj.mesh is not None and obj.impl == "cuda":
        local = _make_sharded_local(obj)
        if local is not None:
            return _sharded_value_and_grad(obj, local)
    loss_fn = make_loss_fn(obj, gnm)

    def autograd_vg(g_axes, target, weight_mask):
        g = g_axes.detach().to(torch.float32).requires_grad_(True)
        with torch.enable_grad():
            loss, fits = loss_fn(g, target, weight_mask)
            (grads,) = torch.autograd.grad(loss, g)
        return (loss.detach(), fits.detach()), grads

    if obj.impl != "cuda" or obj.metric != "mse":
        return autograd_vg

    def fused_vg(g_axes, target, weight_mask):
        if g_axes.shape[1] > render_cuda.MAX_SPLATS:
            return autograd_vg(g_axes, target, weight_mask)
        return render_grad.fused_value_and_grad(
            g_axes, target, weight_mask, obj.H, obj.W,
            boost_only=obj.boost_only, boost_beta=obj.boost_beta, k_sigma=obj.k_sigma,
            background=tuple(obj.background), bin_capacity=obj.bin_capacity,
            cull_eps=_grad_cull_eps(obj), corner_cull=_grad_corner(obj), box=_grad_box(obj),
        )

    return fused_vg


class GradState(NamedTuple):
    g: torch.Tensor  # [B, N, 9] axes-angle genomes; the optimizer's parameter
    opt: torch.optim.Adam
    step: int


def make_adam(g: torch.Tensor, cfg: GradConfig) -> torch.optim.Adam:
    """optax.adam(cfg.lr, b1, b2) (eps 1e-8) over the genome tensor g. On a
    card it is capturable (its step count and bias corrections on the card,
    so a CUDA graph can replay it) and fused (one kernel for the update);
    on the CPU the step count stays on the host."""
    on_card = g.device.type == "cuda"
    return torch.optim.Adam([g], lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8,
                            capturable=on_card, fused=on_card or None)


def make_fit_step(obj: Objective, gnm: GenomeConfig, cfg: GradConfig):
    """-> (make_opt, step): make_opt(g) builds the Adam over g;
    step(state, target, weight_mask, blur_sigma=None) takes one projected
    Adam step and returns (state, fits [B]), the fits before the step.

    With `blur_sigma` (a 0-d tensor) the loss is that of the sigma-blurred
    genomes (anneal.blur_genome_axes) against a caller-blurred target, and
    the gradient chains through the blur back to the raw genome: the JAX
    package's explicit vjp (gradient.py:269-304), here autograd over the
    blur alone, so any value_and_grad path (the fused K7 one included) sees
    only the blurred batch."""
    value_and_grad = make_value_and_grad(obj, gnm)
    make_opt = functools.partial(make_adam, cfg=cfg)

    def step(state: GradState, target, weight_mask, blur_sigma=None) -> Tuple[GradState, torch.Tensor]:
        with profiling.span("adam.step"):
            with profiling.span("adam.value_and_grad"):
                if blur_sigma is None:
                    (_, fits), grads = value_and_grad(state.g, target, weight_mask)
                else:
                    g = state.g.detach().requires_grad_(True)
                    with torch.enable_grad():
                        gb = anneal_mod.blur_genome_axes(g, blur_sigma)
                    (_, fits), grads_b = value_and_grad(gb.detach(), target, weight_mask)
                    (grads,) = torch.autograd.grad(gb, g, grads_b)
            with profiling.span("adam.update"):
                state.g.grad = grads
                state.opt.step()
                with torch.no_grad():
                    # projection: the domain the evolutionary operators keep
                    state.g.copy_(codec.clamp_genome(state.g, obj.H, obj.W, gnm.min_scale,
                                                     gnm.max_scale))
            return GradState(state.g, state.opt, state.step + 1), fits

    return make_opt, step


def init_state(make_opt, g0: torch.Tensor) -> GradState:
    g = g0.detach().to(torch.float32).clone()
    return GradState(g, make_opt(g), 0)


def run_block(state: GradState, step, target, weight_mask, num_steps: int, blur_sigma=None):
    """num_steps steps without a host sync -> (state, fits [num_steps, B])."""
    rows = []
    for _ in range(num_steps):
        state, fits = step(state, target, weight_mask, blur_sigma=blur_sigma)
        rows.append(fits)
    return state, torch.stack(rows)


def _adam_tensors(state: GradState) -> dict:
    """The genomes and the Adam moments and step count, each updated in place."""
    st = state.opt.state[state.g]
    return {"g": state.g, "exp_avg": st["exp_avg"], "exp_avg_sq": st["exp_avg_sq"],
            "step": st["step"]}


def make_run_block(obj: Objective, gnm: GenomeConfig, cfg: GradConfig):
    """-> run(state, target, weight_mask, num_steps, blur_sigma=None) ->
    (state, fits [num_steps, B]): gradient.make_run_block over
    make_fit_step's step, with init_state(run.make_opt, g0) as its state.
    On a card the block is a CUDA graph captured at the first call of each
    (length, shapes, blur on/off) and replayed (utils/block_graph.py). Adam
    updates its genomes and moments in place, so the graph's inputs are the
    state the first call was given (after its first step has made the
    moments); a later call with another state copies its tensors into them
    and returns that first state. The state is donated: read the fits
    before the next call and never reuse a state passed in. Under obj.mesh
    the block stays eager (block_graph.stays_eager: the collectives sync
    through host memory).
    A block_graph.RunBlock: `run.eager` (also `run.loop`; `run.prepare`
    does nothing) is the block run eagerly, `run.graphs` the BlockGraphs
    and `run.make_opt` the Adam its state takes."""
    from ..utils.block_graph import BlockGraphs, RunBlock, stays_eager

    make_opt, step = make_fit_step(obj, gnm, cfg)
    owner: dict = {}  # the state whose tensors the graphs read

    def body(inp, n, step0, _rng):
        st, fits = run_block(owner["state"], step, inp["target"], inp["weight_mask"], n,
                             blur_sigma=inp["blur_sigma"])
        return fits

    def static(inp):
        """The Adam tensors themselves; new buffers for target, mask and sigma."""
        return {k: v if k in ("g", "exp_avg", "exp_avg_sq", "step") or v is None
                else torch.empty_like(v) for k, v in inp.items()}

    graphs = BlockGraphs(body, static=static)

    def eager(state: GradState, target, weight_mask, num_steps: int, blur_sigma=None):
        return run_block(state, step, target, weight_mask, num_steps, blur_sigma=blur_sigma)

    def graphed(state: GradState, target, weight_mask, num_steps: int, blur_sigma=None):
        if state.g not in state.opt.state:  # a fresh Adam: its first step makes the moments
            return eager(state, target, weight_mask, num_steps, blur_sigma)
        key = (tuple(state.g.shape), state.opt.param_groups[0]["lr"])
        own = owner.get(key)
        if own is None:
            own = owner[key] = state
        tensors = _adam_tensors(own)
        if state is not own:
            for k, v in _adam_tensors(state).items():
                tensors[k].copy_(v)
        owner["state"] = own
        fits = graphs(dict(tensors, target=target, weight_mask=weight_mask,
                           blur_sigma=blur_sigma), num_steps, state.step, phase=key)
        return GradState(own.g, own.opt, state.step + num_steps), fits

    return RunBlock(eager, graphed, graphs, lambda state, num_steps: None, eager,
                    not stays_eager(obj), make_opt=make_opt)


def fit_adam(
    target,
    H: int,
    W: int,
    *,
    obj: Optional[Objective] = None,
    gnm: Optional[GenomeConfig] = None,
    cfg: Optional[GradConfig] = None,
    init_genomes=None,
    weight_mask=None,
    seed: int = 42,
    log_every: int = 100,
    progress: bool = True,
    anneal_sigma0: float = 0.0,
    anneal_frac: float = 0.6,
    device="cuda",
):
    """Host loop: Adam-fit `init_genomes` (or a fresh random individual)
    to the target. Returns (best genome [N, 9] np, best loss, loss curve);
    the curve holds each step's best fitness, the best loss is rescored on
    the "highest" energy. anneal_sigma0 > 0 runs the scale-space homotopy:
    the loss of the sigma-smoothed landscape, sigma decaying to 0 over the
    first anneal_frac of the steps (set per block, the target blurred again
    when it steps); the curve then holds smoothed-landscape losses."""
    dev = resolve_device(device)
    obj = obj if obj is not None else Objective(H=H, W=W, impl="oracle")
    gnm = gnm if gnm is not None else GenomeConfig()
    cfg = cfg if cfg is not None else GradConfig()

    if init_genomes is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        init_genomes = genome_mod.new_population(
            gen, 1, gnm.n_splats, H, W, gnm.min_scale, gnm.max_scale, device=dev
        )
    init_genomes = torch.as_tensor(init_genomes, dtype=torch.float32, device=dev)
    if init_genomes.dim() == 2:
        init_genomes = init_genomes[None]
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    if weight_mask is not None:
        weight_mask = torch.as_tensor(weight_mask, dtype=torch.float32, device=dev)

    run = make_run_block(obj, gnm, cfg)
    state = init_state(run.make_opt, init_genomes)

    pbar = None
    if progress:
        try:
            from tqdm.auto import tqdm

            pbar = tqdm(total=cfg.steps, desc="Adam steps")
        except ImportError:
            pbar = None

    radius = anneal_mod.default_radius(anneal_sigma0)
    cur_sigma, sigma_t, cur_target = 0.0, None, target
    curve = []
    done = 0
    try:
        while done < cfg.steps:
            block = min(log_every, cfg.steps - done)
            stepped = anneal_sigma0 > 0.0 and anneal_mod.sigma_step(
                done, cfg.steps, anneal_sigma0, anneal_frac, cur_sigma, target, radius)
            if stepped:
                cur_sigma, sigma_t, cur_target = stepped
            state, fits = run(state, cur_target, weight_mask, block, blur_sigma=sigma_t)
            curve.extend(fits.min(dim=1).values.cpu().tolist())  # the block's one host sync
            done += block
            if pbar is not None:
                pbar.update(block)
                pbar.set_postfix(loss=f"{curve[-1]:.6f}")
    except KeyboardInterrupt:
        print("\n[Interrupted] Returning current state…", flush=True)
    finally:
        if pbar is not None:
            pbar.close()

    # final report: the "highest" energy, whatever tier the steps trained on
    g = state.g.detach()
    loss_fn = make_loss_fn(obj._replace(precision="highest"), gnm)
    with torch.no_grad():
        _, final_fits = loss_fn(g, target, weight_mask)
    b = int(torch.argmin(final_fits))
    return g[b].cpu().numpy(), float(final_fits[b]), curve


def make_refine(obj: Objective, gnm: GenomeConfig, cfg: GradConfig, steps: int):
    """-> refine(elites, elite_fits, target, weight_mask) -> (elites, fits):
    refine_elites built once for a run, as a run block holds it. It keeps
    make_fit_step's closures, an elite buffer [E, N, 9] and one Adam over it
    (make_adam: capturable and fused on a card) for each shape and device.
    A refinement copies the elites into the buffer and sets Adam's moments
    and step count to zero in place (JAX's fresh init_state,
    gradient.py:432-433), so a CUDA graph can replay it without allocating;
    its results equal refine_elites' in bits."""
    make_opt, step = make_fit_step(obj, gnm, cfg)
    held: dict = {}  # (shape, device) -> the GradState over that elite buffer

    def refine(elites, elite_fits, target, weight_mask):
        key = (tuple(elites.shape), str(elites.device))
        state = held.get(key)
        if state is None:
            g = torch.empty(elites.shape, dtype=torch.float32, device=elites.device)
            state = held[key] = GradState(g, make_opt(g), 0)
        with torch.no_grad():
            state.g.copy_(elites)
        for t in state.opt.state.get(state.g, {}).values():  # none before the first step
            t.zero_()
        state, _ = run_block(state, step, target, weight_mask, steps)
        g = state.g.detach()
        new_fits = objective_mod.evaluate(obj, g, target, weight_mask, device=elites.device)
        better = new_fits < elite_fits
        return (torch.where(better[:, None, None], g, elites),
                torch.where(better, new_fits, elite_fits))

    return refine


def refine_elites(
    elites: torch.Tensor,
    elite_fits: torch.Tensor,
    target,
    weight_mask,
    obj: Objective,
    gnm: GenomeConfig,
    cfg: GradConfig,
    steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lamarckian refinement: `steps` Adam steps on the elite batch from a
    fresh Adam; an elite is replaced only if the GA's own evaluator
    (objective.evaluate) scores the refined genome lower. Returns (elites,
    fits)."""
    return make_refine(obj, gnm, cfg, steps)(elites, elite_fits, target, weight_mask)
