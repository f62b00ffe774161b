"""Error-guided splat growth and the densify+prune recycle.

PyTorch counterpart of `ggs_tpu/models/grow.py`. A population grows
between fitting stages: new splats are appended (painted on top) at
pixels sampled from each individual's own residual map without
replacement (gumbel-top-k), coloured from the target and sized small.
`recycle_population` prunes each candidate's lowest-impact splats and
regrows them the same way at fixed N.

The random numbers come from `draw_grow`, or from `draws` (the tests hand
in the JAX package's own). The selection keeps JAX's order: `lax.top_k`
returns the largest perturbed logits in descending order, which becomes
the new splats' painter order (torch.topk with sorted=True), and the prune
takes JAX's tie rule, lower index first among equal impacts (a stable
sort; torch.topk's order among ties is unspecified).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..ops import objective as objective_mod
from ..ops.objective import Objective


def draw_grow(rng: torch.Generator, P: int, n_new: int, H: int, W: int) -> Dict[str, torch.Tensor]:
    """grow_population's random numbers: standard Gumbel noise over every
    pixel of each individual, and the new splats' angles in [-pi, pi)."""
    dev = rng.device
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((P, H * W), generator=rng, device=dev).clamp_min(tiny)
    return {
        "gumbel": -torch.log(-torch.log(u)),
        "theta": torch.rand((P, n_new), generator=rng, device=dev) * (2.0 * math.pi) - math.pi,
    }


def grow_population(
    pop: torch.Tensor,  # [P, N, 9] axes-angle
    n_new: int,
    target: torch.Tensor,  # [H, W, 3]
    obj: Objective,
    weight_mask: Optional[torch.Tensor] = None,
    sigma_px: float = 3.0,
    alpha: float = 220.0,
    rng: Optional[torch.Generator] = None,
    draws: Optional[dict] = None,
) -> torch.Tensor:
    """[P, N, 9] -> [P, N + n_new, 9] with error-guided new splats.

    Positions are the n_new largest gumbel-perturbed log-residuals of each
    individual (its own |render - target|, times weight_mask when given):
    a weighted sample of distinct pixels. Colours are the target's at the
    pixel, scales sigma_px on both axes, angles drawn."""
    P, N, _ = pop.shape
    H, W = obj.H, obj.W
    if draws is None:
        draws = draw_grow(rng, P, n_new, H, W)
    target = target.to(torch.float32)

    imgs = objective_mod.render_genomes(obj, pop, device=pop.device)  # [P, H, W, 3]
    res = torch.sum(torch.abs(imgs - target[None]), dim=-1)  # [P, H, W]
    if weight_mask is not None:
        res = res * weight_mask[None]
    logits = torch.log(res.reshape(P, H * W) + 1e-9)
    idx = torch.topk(logits + draws["gumbel"], n_new, dim=1, sorted=True).indices  # [P, n_new]
    py = torch.div(idx, W, rounding_mode="floor")
    px = idx - py * W

    # normalized xy so that cx = x*(W-1) lands on the sampled pixel
    x = px.to(torch.float32) / max(W - 1, 1)
    y = py.to(torch.float32) / max(H - 1, 1)
    log_s = torch.log(torch.full((P, n_new), sigma_px, dtype=torch.float32, device=pop.device))
    rgb = target[py, px] * 255.0  # [P, n_new, 3]
    a = torch.full((P, n_new), alpha, dtype=torch.float32, device=pop.device)
    new = torch.cat(
        [x[..., None], y[..., None], log_s[..., None], log_s[..., None],
         draws["theta"].to(torch.float32)[..., None], rgb, a[..., None]],
        dim=-1,
    )
    return torch.cat([pop.to(torch.float32), new], dim=1)


def recycle_population(
    pop: torch.Tensor,  # [P, N, 9] axes-angle
    k: int,
    target: torch.Tensor,
    obj: Objective,
    weight_mask: Optional[torch.Tensor] = None,
    sigma_px: float = 3.0,
    alpha: float = 220.0,
    rng: Optional[torch.Generator] = None,
    draws: Optional[dict] = None,
) -> torch.Tensor:
    """Prune each candidate's k lowest-impact splats and regrow them at its
    highest-residual pixels (fixed N). Impact is alpha * sx * sy, the
    splat's integrated mass up to 2*pi; survivors keep their painter order
    and the k new splats go on top. `draws` are draw_grow's for n_new=k."""
    P, N, _ = pop.shape
    if not 0 < k < N:
        raise ValueError(f"recycle k must be in (0, {N}), got {k}")
    imp = pop[..., 8] * torch.exp(pop[..., 2]) * torch.exp(pop[..., 3])  # [P, N]
    # the k lowest impacts, ties to the lower index (lax.top_k(-imp, k))
    prune_idx = torch.argsort(imp, dim=1, stable=True)[:, :k]
    ar = torch.arange(N, device=pop.device)
    pruned = torch.zeros((P, N), dtype=torch.bool, device=pop.device)
    pruned.scatter_(1, prune_idx, True)
    # survivors in original order: sort by (pruned, index), keep N - k
    order = torch.argsort(torch.where(pruned, N + ar, ar), dim=1)[:, : N - k]
    survivors = torch.gather(pop, 1, order[..., None].expand(P, N - k, pop.shape[2]))
    return grow_population(
        survivors, k, target, obj, weight_mask=weight_mask, sigma_px=sigma_px, alpha=alpha,
        rng=rng, draws=draws,
    )
