"""End-to-end objective: axes-angle genomes -> fitness, on one device or
split over a mesh of processes.

PyTorch counterpart of `ggs_tpu/ops/objective.py`: `Objective`,
`evaluate` (with the chunk padding of objective.py:182-195) and
`render_genomes`. Metric "mse" scores in the fused walk (K1, K3 or
K1-bf16); "ssim" and "mix" render the canvases at the objective's tier and
score them with ops/ssim.mixed_energy (objective.py:121-141).

With `obj.mesh` (parallel/mesh.Mesh; set by parallel/shard.sharded_objective)
evaluate splits the batch over the pop shards and the canvas rows over the
tile shards: `_evaluate_fused_sharded` (objective.py:329-409: the fitness
partial of each slab, render_cuda.fitness_partial, summed over the tile
group) and `_evaluate_metric_sharded` (:259-326: the slab's rows,
render_cuda.render_rows, scored by `sharded_energy_rows` with the SSIM halo
from the next slab); the fits are gathered over the pop group, so every
rank returns the whole batch's. Where the shapes do not divide the mesh
(those return None) every rank evaluates the whole batch unsharded, the
counterpart of JAX's GSPMD image route, with the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import resolve_device
from ..parallel import comm, shard
from ..utils import profiling
from . import codec, fitness, render, render_cuda, ssim


class Objective(NamedTuple):
    """Static description of the fitting objective."""

    H: int
    W: int
    k_sigma: float = 3.0
    boost_only: bool = False
    boost_beta: float = 1.0
    impl: str = "cuda"  # "cuda" (tiled walks, K1-K4) | "oracle" (dense)
    chunk: Optional[int] = None
    bin_capacity: Optional[int] = None
    background: Sequence[float] = (1.0, 1.0, 1.0)
    # "mse" (the reference's masked MSE) | "ssim" (DSSIM) | "mix":
    # (1 - ssim_weight) * masked MSE + ssim_weight * DSSIM
    metric: str = "mse"
    ssim_weight: float = 0.5
    # "highest": the reference's conservative box; "exact-tight": the same
    # exact f32 walk over the tight k-sigma box (codec.tighten_boxes_exact);
    # "fast": the exp2 walk (K3) over the eps-tight boxes; "bf16": the exact
    # walk in bf16 (K1-bf16), fitness only
    precision: str = "highest"
    # the fast tier's cull eps (None means the same default) and its rect-min
    # corner cull at that eps; the JAX package's defaults
    cull_eps: Optional[float] = render_cuda.DEFAULT_CULL_EPS
    corner_cull: bool = True
    # parallel/mesh.Mesh: evaluate over a (pop, tile) grid of processes
    mesh: Optional[object] = None


METRICS = ("mse", "ssim", "mix")


def check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")


def _as_f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def render_genomes(
    obj: Objective, g_axes, exact: bool = False, device="cuda"
) -> torch.Tensor:
    """Axes-angle genomes [B, N, 9] -> images [B, H, W, 3] at obj's tier;
    `exact=True` renders precision "highest" without the corner cull,
    whatever obj.precision is."""
    g9 = codec.genome_to_renderer(_as_f32(g_axes, resolve_device(device)))
    return render.render_splats(
        g9, obj.H, obj.W, k_sigma=obj.k_sigma, background=tuple(obj.background),
        impl=obj.impl, bin_capacity=obj.bin_capacity,
        precision="highest" if exact else obj.precision,
        cull_eps=obj.cull_eps, corner_cull=False if exact else obj.corner_cull,
    )


def image_energy(obj: Objective, imgs, target, weight_mask=None) -> torch.Tensor:
    """Rendered canvases [B, H, W, 3] -> obj's energy [B]: the masked MSE, or
    mixed_energy with weight 1 ("ssim") or obj.ssim_weight ("mix"). The one
    home of the metric, for evaluate and the differentiable losses."""
    if obj.metric == "mse":
        return fitness.fitness_from_images(
            imgs, target, weight_mask=weight_mask,
            boost_only=obj.boost_only, boost_beta=obj.boost_beta,
        )
    return ssim.mixed_energy(
        imgs, target, weight_mask=weight_mask,
        ssim_weight=1.0 if obj.metric == "ssim" else obj.ssim_weight,
        boost_only=obj.boost_only, boost_beta=obj.boost_beta,
    )


def evaluate(
    obj: Objective,
    g_axes,
    target,
    weight_mask=None,
    device="cuda",
) -> torch.Tensor:
    """Axes-angle genomes [B, N, 9] -> fitness [B] (lower is better).

    Inputs may be numpy arrays or tensors; they are moved to `device`.
    With obj.chunk set, at most chunk candidates are scored at once."""
    with profiling.span("objective.evaluate"):
        check_metric(obj.metric)
        dev = resolve_device(device)
        g_axes = _as_f32(g_axes, dev)
        target = _as_f32(target, dev)
        weight_mask = None if weight_mask is None else _as_f32(weight_mask, dev)
        if g_axes.dim() == 2:
            g_axes = g_axes[None]
        B = g_axes.shape[0]

        def eval_batch(g):
            if obj.mesh is not None and obj.impl == "cuda":
                sharded = (_evaluate_fused_sharded if obj.metric == "mse"
                           else _evaluate_metric_sharded)
                out = sharded(obj, g, target, weight_mask)
                if out is not None:
                    return out
            if obj.metric != "mse":
                return image_energy(obj, render_genomes(obj, g, device=dev), target, weight_mask)
            g9 = codec.genome_to_renderer(g)
            if obj.impl == "cuda":
                return render_cuda.fitness(
                    g9, target, weight_mask, obj.H, obj.W, k_sigma=obj.k_sigma,
                    background=tuple(obj.background), boost_only=obj.boost_only,
                    boost_beta=obj.boost_beta, bin_capacity=obj.bin_capacity,
                    precision=obj.precision, cull_eps=obj.cull_eps, corner_cull=obj.corner_cull,
                )
            imgs = render.render_splats(
                g9, obj.H, obj.W, k_sigma=obj.k_sigma, background=tuple(obj.background),
                impl=obj.impl, bin_capacity=obj.bin_capacity, precision=obj.precision,
                cull_eps=obj.cull_eps, corner_cull=obj.corner_cull,
            )
            return image_energy(obj, imgs, target, weight_mask)

        if obj.chunk is None or obj.chunk >= B:
            return eval_batch(g_axes)

        # When chunk doesn't divide B, pad with copies of the first genome so
        # every chunk has the same shape, then drop the padding.
        n_chunks = -(-B // obj.chunk)
        Bp = n_chunks * obj.chunk
        if Bp != B:
            pad = g_axes[:1].expand(Bp - B, *g_axes.shape[1:])
            g_axes = torch.cat([g_axes, pad], dim=0)
        fits = [eval_batch(g) for g in g_axes.split(obj.chunk)]
        return torch.cat(fits)[:B]


_SSIM_WIN = 11  # Wang et al.'s window, on every SSIM path


def sharded_metric_viable(obj: Objective) -> bool:
    """True where the row-slab partition is exact for obj's mesh
    (objective.py:201-214): the canvas rows divide the tile axis and, for
    SSIM and mix, a slab is at least one halo (window - 1 rows) tall."""
    ntile = obj.mesh.tile_shards
    if obj.H % ntile:
        return False
    halo = _SSIM_WIN - 1
    if obj.metric != "mse" and (obj.H // ntile < halo or obj.W < _SSIM_WIN
                                or obj.H < _SSIM_WIN):
        return False
    return True


def sharded_energy_rows(obj: Objective, imgs, tgt_rows, w_rows, y0: int, mesh):
    """This slab's canvas rows [B, Hs, W, 3] -> the whole canvas's energy [B]
    (objective.py:217-256), summed over the mesh's tile group; the one home
    of the sharded metric, for the fitness and the differentiable loss. The
    SSIM halo (the next slab's first window - 1 rows of canvas and target)
    arrives by comm.halo_next; the masked-MSE and valid-window SSIM partials
    are summed by comm.psum, so autograd flows through both. The caller has
    checked sharded_metric_viable."""
    H, W = obj.H, obj.W
    halo = _SSIM_WIN - 1
    w_eff, denom = fitness.sharded_weff_denom(w_rows, obj.boost_only, obj.boost_beta, H, W,
                                              lambda x: comm.tile_sum(x, mesh))
    d2 = torch.sum((imgs - tgt_rows[None]) ** 2, dim=-1)
    num = torch.sum(d2 if w_eff is None else d2 * w_eff[None], dim=(1, 2))
    mse = comm.psum(num, mesh) / denom
    wmix = 0.0 if obj.metric == "mse" else (1.0 if obj.metric == "ssim" else obj.ssim_weight)
    if wmix <= 0.0:
        return mse
    imgs_ext = torch.cat([imgs, comm.halo_next(imgs[:, :halo], mesh)], dim=1)
    tgt_ext = torch.cat([tgt_rows, comm.halo_next(tgt_rows[:halo], mesh)], dim=0)
    ssum = ssim.ssim_sum_rows(imgs_ext, tgt_ext, y0, H, window_size=_SSIM_WIN)
    n_windows = float((H - _SSIM_WIN + 1) * (W - _SSIM_WIN + 1) * 3)
    dssim_e = (1.0 - comm.psum(ssum, mesh) / n_windows) / 2.0
    if obj.metric == "ssim":
        return dssim_e
    return (1.0 - wmix) * mse + wmix * dssim_e


def _slab(obj: Objective, g, target, weight_mask):
    """This rank's pop rows of g, its slab's first row and its rows of the
    target and mask, or None where the batch does not divide the pop axis
    or the canvas the tile axis."""
    mesh = obj.mesh
    if g.shape[0] % mesh.pop_shards or obj.H % mesh.tile_shards:
        return None
    return (shard.place_pop(g, mesh), shard.tile_rows(obj.H, mesh).start,
            shard.place_target(target, mesh), shard.place_mask(weight_mask, mesh))


def _evaluate_fused_sharded(obj: Objective, g, target, weight_mask):
    """Fused fitness over the mesh (objective.py:329-409): each rank walks
    its pop rows on its row slab (render_cuda.fitness_partial: K1, K3 or
    K1-bf16 on the slab's lists), the partials and the mask's sums are
    summed over the tile group and the fits gathered over the pop group.
    None where the shapes do not divide the mesh or no tile height of 64,
    32, 16 or 8 rows divides a slab."""
    sl = _slab(obj, g, target, weight_mask)
    if sl is None:
        return None
    g_loc, y0, tgt_rows, w_rows = sl
    Hs = tgt_rows.shape[0]
    tile_h = render_cuda.slab_tile_h(Hs)
    if tile_h is None:
        return None
    mesh = obj.mesh
    w_eff, denom = fitness.sharded_weff_denom(w_rows, obj.boost_only, obj.boost_beta, obj.H,
                                              obj.W, lambda x: comm.tile_sum(x, mesh))
    num = render_cuda.fitness_partial(
        codec.genome_to_renderer(g_loc), tgt_rows, w_eff, obj.H, obj.W, y0,
        k_sigma=obj.k_sigma, background=tuple(obj.background), bin_capacity=obj.bin_capacity,
        tile_h=tile_h, tile_w=128, precision=obj.precision, cull_eps=obj.cull_eps,
        corner_cull=obj.corner_cull,
    )
    return comm.pop_gather(comm.tile_sum(num, mesh) / denom, mesh)


def _evaluate_metric_sharded(obj: Objective, g, target, weight_mask):
    """SSIM / mix energy over the mesh (objective.py:259-326): each rank
    renders its pop rows' canvases on its row slab (render_cuda.render_rows,
    whose "bf16" renders as "highest", :301-305) and scores them with
    sharded_energy_rows; the fits are gathered over the pop group. None
    where the shapes do not divide the mesh or a slab is shorter than the
    SSIM halo."""
    if not sharded_metric_viable(obj):
        return None
    sl = _slab(obj, g, target, weight_mask)
    if sl is None:
        return None
    g_loc, y0, tgt_rows, w_rows = sl
    imgs = render_cuda.render_rows(
        codec.genome_to_renderer(g_loc), obj.H, obj.W, y0, tgt_rows.shape[0],
        k_sigma=obj.k_sigma, background=tuple(obj.background), bin_capacity=obj.bin_capacity,
        precision=obj.precision, cull_eps=obj.cull_eps, corner_cull=obj.corner_cull,
    )
    out = sharded_energy_rows(obj, imgs, tgt_rows, w_rows, y0, obj.mesh)
    return comm.pop_gather(out, obj.mesh)
