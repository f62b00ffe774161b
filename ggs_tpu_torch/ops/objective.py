"""End-to-end objective: axes-angle genomes -> fitness on one device.

PyTorch counterpart of the single-device part of `ggs_tpu/ops/objective.py`:
`Objective`, `evaluate` (with the chunk padding of objective.py:182-195)
and `render_genomes`. Only metric="mse" is ported; the SSIM/mix metrics
and the sharded paths raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import resolve_device
from . import codec, fitness, render, render_cuda


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
    metric: str = "mse"
    # "highest": the reference's conservative box; "exact-tight": the same
    # exact f32 walk over the tight k-sigma box (codec.tighten_boxes_exact);
    # "fast": the exp2 walk (K3) over the eps-tight boxes; "bf16": the exact
    # walk in bf16 (K1-bf16), fitness only
    precision: str = "highest"
    # the fast tier's cull eps (None means the same default) and its rect-min
    # corner cull at that eps; the JAX package's defaults
    cull_eps: Optional[float] = render_cuda.DEFAULT_CULL_EPS
    corner_cull: bool = True


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
    if obj.metric != "mse":
        raise NotImplementedError(f"metric={obj.metric!r} is not ported yet (only 'mse')")
    dev = resolve_device(device)
    g_axes = _as_f32(g_axes, dev)
    target = _as_f32(target, dev)
    weight_mask = None if weight_mask is None else _as_f32(weight_mask, dev)
    if g_axes.dim() == 2:
        g_axes = g_axes[None]
    B = g_axes.shape[0]

    def eval_batch(g):
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
        return fitness.fitness_from_images(
            imgs, target, weight_mask=weight_mask,
            boost_only=obj.boost_only, boost_beta=obj.boost_beta,
        )

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
