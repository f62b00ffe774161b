"""Renderer front door: one call, two backends (ggs_tpu/ops/render.py).

* impl="cuda": the tiled walk of ops/render_cuda.py (the K2 kernel, or K3
  under precision "fast", on CUDA tensors; their plain versions on CPU
  tensors).
* impl="oracle": the dense painter-order renderer of ops/oracle.py.

precision "highest" renders the reference's conservative box and
"exact-tight" the tight k-sigma box, in both backends. "fast" renders the
exp2 walk over the eps-tight boxes (with the corner cull when corner_cull)
in the cuda backend; "bf16" has no image walk of its own and renders as
"highest". The oracle has no fast walk and renders both as exact, never
looser than asked (ggs_tpu/ops/render.py:55-67).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import oracle, render_cuda, screen


def render_splats(
    g9: torch.Tensor,
    H: int,
    W: int,
    *,
    k_sigma: float = 3.0,
    background: Sequence[float] = (1.0, 1.0, 1.0),
    impl: str = "cuda",
    bin_capacity: Optional[int] = None,
    tile_h: int = 64,
    tile_w: int = 128,
    precision: str = "highest",
    cull_eps: Optional[float] = None,
    corner_cull: bool = False,
) -> torch.Tensor:
    """Renderer genomes [B, N, 9] (or [N, 9]) -> images [B, H, W, 3] in [0, 1]."""
    t = screen.tier(precision, cull_eps, corner_cull)
    if impl == "oracle":
        return oracle.render_dense(
            g9, H, W, k_sigma=k_sigma, background=tuple(background), box=t.exact_box,
        )
    if impl == "cuda":
        return render_cuda.render(
            g9, H, W, k_sigma=k_sigma, background=tuple(background),
            bin_capacity=bin_capacity, tile_h=tile_h, tile_w=tile_w, precision=precision,
            cull_eps=cull_eps, corner_cull=corner_cull,
        )
    raise ValueError(f"unknown renderer impl: {impl!r}")
