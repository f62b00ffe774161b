"""Dense painter-order renderer: the port's correctness anchor.

PyTorch counterpart of `ggs_tpu/ops/oracle.py` (`render_xla`): the
reference compositor's closed form over the whole canvas,

    C_0 = background;  C_i = (1 - f_i) C_{i-1} + f_i color_i
    f_i = alpha_i * exp(-0.5 d^T Sigma_i^{-1} d) inside the splat's integer
    AABB, 0 outside; final clamp to [0, 1],

as a Python loop over splats in painter order. No tiles, no lists, no
kernels: it shares only the codec with the tiled path it checks.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import codec


def splat_weights(p: codec.SplatScreen, xf: torch.Tensor, yf: torch.Tensor) -> torch.Tensor:
    """Per-pixel weight f; p fields and xf/yf broadcast together
    (modules/render.py:189-196)."""
    qx = xf - p.cx
    qy = yf - p.cy
    quad = p.sxx * (qx * qx) + 2.0 * p.sxy * (qx * qy) + p.syy * (qy * qy)
    f = torch.exp(-0.5 * quad) * p.a
    m = (xf >= p.x0) & (xf <= p.x1) & (yf >= p.y0) & (yf <= p.y1)
    return torch.where(m, f, torch.zeros((), dtype=f.dtype, device=f.device))


def render_dense(
    g9: torch.Tensor,
    H: int,
    W: int,
    k_sigma: float = 3.0,
    background: Sequence[float] = (1.0, 1.0, 1.0),
    box: str = "reference",  # "reference" (conservative hy) | "tight"
) -> torch.Tensor:
    """Renderer-format genomes [B, N, 9] (or [N, 9]) -> [B, H, W, 3] f32.

    box="tight" applies codec.tighten_boxes_exact, the ground truth of the
    tiled path's precision="exact-tight"."""
    if box not in ("reference", "tight"):
        raise ValueError(f"unknown box {box!r}")
    squeeze = g9.dim() == 2
    if squeeze:
        g9 = g9[None]
    B, N, C = g9.shape
    if C < codec.GENE_DIM:
        raise ValueError(f"expected >= 9 genome cols, got {C}")
    g9 = g9[..., : codec.GENE_DIM].to(torch.float32)

    p = codec.preprocess(g9, H, W, k_sigma)
    if box == "tight":
        p = codec.tighten_boxes_exact(p, k_sigma)

    dev = g9.device
    xf = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]  # [1, 1, W]
    yf = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]  # [1, H, 1]
    bg = torch.tensor([float(c) for c in background], dtype=torch.float32, device=dev)
    canvas = bg.expand(B, H, W, 3).clone()
    for i in range(N):
        pi = codec.SplatScreen(*(t[:, i, None, None] for t in p))  # [B, 1, 1]
        f = splat_weights(pi, xf, yf)[..., None]  # [B, H, W, 1]
        color = torch.stack([pi.rc, pi.gc, pi.bc], dim=-1)  # [B, 1, 1, 3]
        canvas = (1.0 - f) * canvas + f * color
    out = torch.clamp(canvas, 0.0, 1.0)
    return out[0] if squeeze else out
