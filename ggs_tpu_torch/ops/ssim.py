"""SSIM: the structural-similarity energy (ggs_tpu/ops/ssim.py).

The standard Wang et al. SSIM with an 11x11 Gaussian window (sigma 1.5),
K1=0.01, K2=0.03 and dynamic range 1.0, computed per channel and averaged,
differentiable through autograd. As energies (lower is better):
    dssim(imgs, target) = (1 - mean SSIM) / 2  in [0, 1]
    mixed_energy(imgs, target, w) = (1 - w) * masked-MSE + w * DSSIM

The window is separable, outer(g, g), and `_filter2` applies it as two
11-tap passes (rows, then columns), each a float32 sum of shifted slices
in tap order: no convolution, so no cuDNN or cuBLAS routine and nothing
that PyTorch's TF32 flags (`torch.backends.cudnn.allow_tf32` is on by
default) can lower to a 10-bit mantissa. The JAX package pins its conv to
HIGHEST for the same reason (ssim.py:31-48): reduced-precision
E[x^2] - mu^2 estimates flipped the SSIM denominator's sign, and a GA then
exploited the pole. Every operation is an elementwise multiply or add, so
the card and the CPU round alike. The separable order rounds differently
from JAX's 2-D conv; tests/test_torch_ssim.py states the gap.

`ssim_sum_rows` is the row-slab partial of the tile-sharded paths
(ops/objective.sharded_energy_rows).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import fitness as fitness_mod

_K1 = 0.01
_K2 = 0.03


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> Tuple[float, ...]:
    """The window's 1-D factor g (sum 1), each tap a float32 value; the JAX
    package's 2-D window is outer(g, g). Python floats, so the filter's
    multiplies take them as scalars and nothing is copied to the card."""
    f32 = np.float32
    x = np.arange(size, dtype=f32) - f32((size - 1) / 2.0)
    g = np.exp(-(x**2) / f32(2.0 * sigma**2))
    g = g / np.sum(g, dtype=f32)
    return tuple(float(v) for v in g.astype(f32))


def _pass(x: torch.Tensor, taps: Tuple[float, ...], dim: int) -> torch.Tensor:
    """'valid' 1-D filter of x along dim: sum_k taps[k] * x[i + k], in order."""
    n = x.shape[dim] - len(taps) + 1
    out = x.narrow(dim, 0, n) * taps[0]
    for k in range(1, len(taps)):
        out = out + x.narrow(dim, k, n) * taps[k]
    return out


def _filter2(img_hwc: torch.Tensor, taps: Tuple[float, ...]) -> torch.Tensor:
    """Depthwise 'valid' filter of [..., H, W, C] by the window outer(taps,
    taps) -> [..., H-k+1, W-k+1, C]: a pass over rows, then over columns."""
    return _pass(_pass(img_hwc, taps, -3), taps, -2)


def ssim(
    imgs: torch.Tensor,
    target: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
) -> torch.Tensor:
    """imgs [B, H, W, 3], target [H, W, 3] -> mean SSIM [B] in [-1, 1].

    Variance estimates are clamped to >= 0 inside _ssim_map: true variances
    are nonnegative, and the float32 cancellation otherwise lets the SSIM
    denominator cross zero."""
    taps = _gaussian_window(window_size, sigma)
    s = _ssim_map(imgs, target[None], taps, data_range)
    return torch.mean(s, dim=(1, 2, 3))


def _ssim_map(imgs: torch.Tensor, t: torch.Tensor, taps, data_range: float) -> torch.Tensor:
    """Per-window-position SSIM map [B, Ho, Wo, C] (valid positions); t
    [1, H, W, C] is filtered once and broadcast over the batch."""
    c1 = (_K1 * data_range) ** 2
    c2 = (_K2 * data_range) ** 2
    mu_x, e_xx, e_xy = _filter2(torch.stack([imgs, imgs * imgs, imgs * t]), taps)
    mu_y, e_yy = _filter2(torch.stack([t, t * t]), taps)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    # torch.maximum splits the gradient at a tie as jnp.maximum does (a flat
    # window's variance is exactly 0, e.g. on the background)
    zero = imgs.new_zeros(())
    sig_xx = torch.maximum(e_xx - mu_xx, zero)
    sig_yy = torch.maximum(e_yy - mu_yy, zero)
    sig_xy = e_xy - mu_xy
    return ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sig_xx + sig_yy + c2)
    )


def ssim_sum_rows(
    imgs_ext: torch.Tensor,
    target_ext: torch.Tensor,
    y0: int,
    H: int,
    window_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
) -> torch.Tensor:
    """Row-slab SSIM partial (ssim.py:86-115): the sum of the SSIM map over
    this slab's valid window rows -> [B]. imgs_ext [B, rows + w - 1, W, 3]
    and target_ext [rows + w - 1, W, 3] hold the slab's rows and the
    window_size - 1 halo rows below them (the next slab's first rows). Window
    row r is valid iff y0 + r <= H - window_size; the rows past that (only
    the bottom slab has any, whose halo wrapped around) are left out of the
    sum, so the partials summed over a canvas's slabs divided by
    (H-w+1)(W-w+1)C give the canvas's mean SSIM (window sums never cross a
    slab boundary thanks to the halo)."""
    taps = _gaussian_window(window_size, sigma)
    rows = imgs_ext.shape[1] - window_size + 1
    n_valid = max(0, min(rows, H - window_size - int(y0) + 1))
    # the valid rows' windows read rows [0, n_valid + w - 1) of the slab
    keep = n_valid + window_size - 1
    s = _ssim_map(imgs_ext[:, :keep], target_ext[None, :keep], taps, data_range)
    return torch.sum(s, dim=(1, 2, 3))


def dssim(imgs: torch.Tensor, target: torch.Tensor, **kw) -> torch.Tensor:
    """Structural dissimilarity energy in [0, 1]; 0 iff the images are identical."""
    return (1.0 - ssim(imgs, target, **kw)) / 2.0


def mixed_energy(
    imgs: torch.Tensor,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor] = None,
    ssim_weight: float = 0.5,
    boost_only: bool = False,
    boost_beta: float = 1.0,
) -> torch.Tensor:
    """(1 - w) * masked-MSE + w * DSSIM, the fused MSE/SSIM objective [B]."""
    mse = fitness_mod.fitness_from_images(
        imgs, target, weight_mask=weight_mask, boost_only=boost_only, boost_beta=boost_beta
    )
    if ssim_weight <= 0.0:
        return mse
    d = dssim(imgs, target)
    return (1.0 - ssim_weight) * mse + ssim_weight * d
