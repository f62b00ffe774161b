"""Importance mask: multi-scale edges + local variance -> per-pixel weights.

PyTorch counterpart of `ggs_tpu/ops/mask.py` (modules/mask.py:6-83):
Rec.709 luma, bilinear resize to the working size, Sobel edge magnitude
at scales (1, 2, 4), 9x9 local variance, 2%/98%-quantile normalization,
a 0.7/0.3 blend, optional box smoothing, gamma, floor and strength.

Two numerical traps of the port are closed here:
* cuDNN runs float32 convolutions in TF32 by default; the Sobel filter is
  therefore written as shifted sums, and pooling uses PyTorch's native
  average-pool kernel, both in full float32.
* `jax.image.resize(..., "bilinear")` antialiases when it downsamples;
  `F.interpolate` does so only with `antialias=True`, which is passed.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    """Scale 0..255 inputs to 0..1 (modules/mask.py:7, 42)."""
    return torch.where(torch.max(x) > 1.5, x / 255.0, x)


def rgb_to_luma(img_hw3: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] -> [H, W] Rec.709 luma (modules/mask.py:6-10)."""
    x = _to_unit(img_hw3)
    return 0.2126 * x[..., 0] + 0.7152 * x[..., 1] + 0.0722 * x[..., 2]


def _conv3x3_same(y_hw: torch.Tensor, k33) -> torch.Tensor:
    """3x3 cross-correlation with zero padding 1, as shifted sums in f32."""
    H, W = y_hw.shape
    yp = F.pad(y_hw, (1, 1, 1, 1))
    out = torch.zeros_like(y_hw)
    for i in range(3):
        for j in range(3):
            if k33[i][j] != 0.0:
                out = out + k33[i][j] * yp[i : i + H, j : j + W]
    return out


def sobel_edges(y_hw: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude (modules/mask.py:13-18)."""
    gx = _conv3x3_same(y_hw, _SOBEL_X)
    gy = _conv3x3_same(y_hw, _SOBEL_Y)
    return torch.sqrt(gx * gx + gy * gy + 1e-12)


def _avg_pool(y_hw: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """Average pool with count_include_pad=True: the divisor is always k*k."""
    return F.avg_pool2d(y_hw[None, None], k, stride, pad, count_include_pad=True)[0, 0]


def local_variance(y_hw: torch.Tensor, k: int = 9) -> torch.Tensor:
    """Windowed variance via E[x^2] - E[x]^2, clamped >= 0 (modules/mask.py:21-25)."""
    pad = k // 2
    mean = _avg_pool(y_hw, k, 1, pad)
    mean2 = _avg_pool(y_hw * y_hw, k, 1, pad)
    return torch.clamp_min(mean2 - mean * mean, 0.0)


def _norm01(t: torch.Tensor) -> torch.Tensor:
    """Robust normalize by the 2%/98% quantiles (modules/mask.py:62-65)."""
    flat = t.reshape(-1)
    ql = torch.quantile(flat, 0.02)
    qh = torch.quantile(flat, 0.98)
    return torch.clamp((t - ql) / (qh - ql + 1e-12), 0.0, 1.0)


def resize_bilinear(x_chw: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[C, h, w] -> [C, H, W], half-pixel centers, antialiased when shrinking
    (the jax.image.resize "bilinear" contract)."""
    if tuple(x_chw.shape[-2:]) == (H, W):
        return x_chw
    return F.interpolate(
        x_chw[None], size=(H, W), mode="bilinear", align_corners=False, antialias=True
    )[0]


def compute_importance_mask(
    target_hw3: torch.Tensor,
    H: int,
    W: int,
    edge_scales: Sequence[int] = (1, 2, 4),
    w_edge: float = 0.7,
    w_var: float = 0.3,
    gamma: float = 0.7,
    floor: float = 0.15,
    smooth: int = 0,
    strength: float = 1.0,
) -> torch.Tensor:
    """Target image [H0, W0, 3] -> importance weights [H, W] in
    [(1-strength) + strength*floor', 1] (modules/mask.py:29-83)."""
    x = _to_unit(target_hw3.to(torch.float32))
    x = resize_bilinear(x.permute(2, 0, 1), H, W).permute(1, 2, 0)
    y = rgb_to_luma(x)  # already unit scale

    edges = torch.zeros_like(y)
    for s in edge_scales:
        if s > 1:
            yd = _avg_pool(y, s, s, 0)[: H // s, : W // s]
            e = resize_bilinear(sobel_edges(yd)[None], H, W)[0]
        else:
            e = sobel_edges(y)
        edges = edges + e

    var = local_variance(y, k=9)

    E = _norm01(edges)
    V = _norm01(var)
    m = _norm01(w_edge * E + w_var * V)
    if smooth and smooth > 0:
        m = _norm01(_avg_pool(m, smooth, 1, smooth // 2))
    m = m**gamma
    m = (1.0 - floor) * m + floor
    return (1.0 - strength) * torch.ones_like(m) + strength * m


def mask_from_config(target_hw3: torch.Tensor, H: int, W: int, cfg) -> torch.Tensor:
    """compute_importance_mask with every field of a MaskConfig."""
    return compute_importance_mask(
        target_hw3, H, W,
        edge_scales=tuple(cfg.edge_scales), w_edge=cfg.w_edge, w_var=cfg.w_var,
        gamma=cfg.gamma, floor=cfg.floor, smooth=cfg.smooth, strength=cfg.strength,
    )
