"""End-to-end objective: axes-angle genomes -> fitness on one device.

PyTorch counterpart of the single-device part of `ggs_tpu/ops/objective.py`:
`Objective`, `evaluate` (with the chunk padding of objective.py:182-195)
and `render_genomes`. Metric "mse" scores in the fused walk (K1, K3 or
K1-bf16); "ssim" and "mix" render the canvases at the objective's tier and
score them with ops/ssim.mixed_energy (objective.py:121-141). The sharded
paths are not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import resolve_device
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
    check_metric(obj.metric)
    dev = resolve_device(device)
    g_axes = _as_f32(g_axes, dev)
    target = _as_f32(target, dev)
    weight_mask = None if weight_mask is None else _as_f32(weight_mask, dev)
    if g_axes.dim() == 2:
        g_axes = g_axes[None]
    B = g_axes.shape[0]

    def eval_batch(g):
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
