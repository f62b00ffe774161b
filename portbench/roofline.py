"""The least time of the walks, counted from the genomes: the yardstick of
the `*_roofline_pct` metrics.

The operation counts are frozen copies of chip_smoke.py:259-305 (each f32
operation and exp counted as 1; the walks are built with -fmad=false) and
the arithmetic of its `bound` (:471-519). The work is counted from each
candidate's exact-tight pixel box (reference.screen: codec.preprocess and
codec.tighten_boxes_exact), clipped to the canvas and split at the tile
grid of the configuration, never from the program's lists, padding or
passes: a change to binning, boxes or list padding moves the program's
time and not this count.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
"""
from __future__ import annotations

import torch

from . import reference

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# forward walk (K1, K2): per (splat, pixel) pair in the box, per (splat,
# column) pair in the box within a tile row, per pixel of K1's loss epilogue
OPS_PER_PAIR_PIXEL = 21
OPS_PER_PAIR_COLUMN = 5
OPS_PER_PIXEL = 16
# value and gradient (K2' forward, K6 backward): one forward step (23) and
# one backward step (45) per pair-pixel, one walk's 5 per pair-column
OPS_PER_PAIR_PIXEL_GRAD = 23 + 45
OPS_PER_PAIR_COLUMN_GRAD = 5
GENE_BYTES = 9 * 4


def pair_counts(g: torch.Tensor, H: int, W: int, tile_h: int, k_sigma: float = 3.0,
                chunk: int = 128):
    """Genomes [K, N, 9] -> (pair-pixels, pair-columns) summed over the K
    candidates: each box's area, and its width times the tile rows it
    spans; `chunk` candidates at a time."""
    px = cols = 0.0
    with torch.no_grad():
        for c in g.split(chunk):
            b = reference.screen(c.to(torch.float32), H, W, k_sigma).box.double()
            w = (b[..., 1] - b[..., 0] + 1).clamp_min(0)
            h = (b[..., 3] - b[..., 2] + 1).clamp_min(0)
            rows = torch.div(b[..., 3], tile_h, rounding_mode="floor") - torch.div(
                b[..., 2], tile_h, rounding_mode="floor") + 1
            px += float((w * h).sum())
            cols += float((w * rows.clamp_min(0) * (h > 0)).sum())
    return px, cols


def forward_least_s(pair_px: float, pair_cols: float, renders: int, gens: int, H: int, W: int,
                    n_splats: int) -> float:
    """Least seconds for `renders` fitness walks (pair counts summed over
    them) in `gens` generations: operations at the f32 peak or bytes at
    the memory rate (genomes read, fits written, target and mask read once
    a generation), whichever is larger."""
    ops = OPS_PER_PAIR_PIXEL * pair_px + OPS_PER_PAIR_COLUMN * pair_cols
    ops += OPS_PER_PIXEL * H * W * renders
    nbytes = renders * (GENE_BYTES * n_splats + 4) + gens * 16 * H * W
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def gradient_least_s(pair_px: float, pair_cols: float, steps: int, H: int, W: int,
                     n_splats: int) -> float:
    """Least seconds for `steps` value-and-gradient walks (pair counts summed
    over them): genome read, gradient written, image cotangent read."""
    ops = OPS_PER_PAIR_PIXEL_GRAD * pair_px + OPS_PER_PAIR_COLUMN_GRAD * pair_cols
    nbytes = steps * (2 * GENE_BYTES * n_splats + 12 * H * W)
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
