"""Fitness: (importance-masked) MSE between rendered candidates and a target.

PyTorch counterpart of `ggs_tpu/ops/fitness.py`: the three scoring modes
of modules/fitness.py:8-31 (plain mean MSE, normalized weighted MSE, and
boost-only), and `weff_denom`, their single home for the fused walk, with
`sharded_weff_denom`, its row-slab form for the tile-sharded paths.
"""
from __future__ import annotations

from typing import Optional

import torch


def fitness_from_images(
    imgs: torch.Tensor,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor] = None,
    boost_only: bool = False,
    boost_beta: float = 1.0,
) -> torch.Tensor:
    """imgs [B, H, W, 3], target [H, W, 3], weight_mask [H, W] -> fitness [B]."""
    dif2 = (imgs - target[None]) ** 2  # [B, H, W, 3]

    if weight_mask is None:
        return torch.mean(dif2, dim=(1, 2, 3))

    w = weight_mask[None, :, :, None]  # [1, H, W, 1]

    if boost_only:
        # mean(dif2 * (1 + beta*w)) / (mean(1 + beta*w) + eps)
        w_boost = 1.0 + boost_beta * torch.clamp(w, 0.0, 1.0)
        num = torch.mean(dif2 * w_boost, dim=(1, 2, 3))
        den = torch.mean(w_boost, dim=(1, 2, 3)) + 1e-12
        return num / den

    # sum(dif2 * w) / (sum(w) + eps): channel-summed numerator, per-pixel
    # denominator (modules/fitness.py:29-31).
    num = torch.sum(dif2 * w, dim=(1, 2, 3))
    den = torch.sum(w, dim=(1, 2, 3)) + 1e-12
    return num / den


def weff_denom(weight_mask, boost_only, boost_beta, H, W):
    """(effective weight plane [H, W] or None, scalar denominator) such that
    fitness == sum_px(w_eff * sum_ch dif^2) / denom in every scoring mode of
    fitness_from_images (render_pallas.py:1333-1341)."""
    hw3 = torch.tensor(float(H * W * 3), dtype=torch.float32)
    if weight_mask is None:
        return None, hw3
    # hw3 stays a 0-d CPU tensor: it enters device arithmetic as a scalar,
    # where a copy to the card would synchronize the host every call
    w = weight_mask.to(torch.float32)
    if boost_only:
        w_eff = 1.0 + boost_beta * torch.clamp(w, 0.0, 1.0)
        return w_eff, (torch.mean(w_eff) + 1e-12) * hw3
    return w, torch.sum(w) + 1e-12


def sharded_weff_denom(w_rows, boost_only, boost_beta, H, W, tile_sum):
    """(w_eff over this slab's rows [Hs, W] or None, the whole canvas's
    scalar denominator) for the tile-sharded fitness and loss (fitness.py:
    68-87): the slab's partials sum(w_eff * sum_ch dif^2), summed over the
    tile group, divided by it give fitness_from_images. `tile_sum` sums a
    tensor over the tile group (the identity on one process), so the
    mask-dependent sums are the whole canvas's."""
    hw3 = torch.tensor(float(H * W * 3), dtype=torch.float32)
    if w_rows is None:
        return None, hw3
    if boost_only:
        w_eff = 1.0 + boost_beta * torch.clamp(w_rows.to(torch.float32), 0.0, 1.0)
        mean_w = tile_sum(torch.sum(w_eff)) / float(H * W)
        return w_eff, (mean_w + 1e-12) * hw3
    w_eff = w_rows.to(torch.float32)
    return w_eff, tile_sum(torch.sum(w_eff)) + 1e-12
