"""The screen-space front end of the forward and gradient walks: what a
precision tier decides, the screen step and the passes.

A tier decides which boxes the walks bin and clip (the reference's, the
tight k-sigma box or the eps-tight one), at which eps, whether the corner
cull runs, and which table and walk the forward epilogue takes. The JAX
package decides this in `render_pallas.render_pallas` / `fitness_pallas`
(:1345-1421) for the forward walks and in `render_grad.py` (:670-826) for
the gradient walks; here `Tier` holds it once for both:

* `tier(precision, cull_eps, corner_cull)`: the forward entry points' and
  an Objective's tier (ops/render_cuda.py, ops/render.py, models/gradient.py).
* `box_tier(box, cull_eps, corner_cull)`: render_grad's public arguments,
  whose walk is always the exact one (K2', K6, K7).
* `screen`: preprocess, the shift into a row slab, then the tier's boxes,
  under the `render.screen` span.
* `passes`: a screen cut into the passes of at most render_cuda.MAX_SPLATS
  splats that the walks chain through the init canvas.

render_cuda imports this module; the box helpers and the pass size stay
there and are read at call time (render_cuda.MAX_SPLATS may be lowered).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..utils import profiling
from . import codec, render_cuda


class Tier(NamedTuple):
    """A precision tier's rule for both walks."""

    box: str  # "reference" (preprocess'), "tight" (the k-sigma box) or "eps" (eps-tight)
    eps: Optional[float]  # the eps of the "eps" boxes, resolved; None for the others
    corner_eps: Optional[float]  # the corner cull's eps; None: no corner cull
    mode: str  # the forward walks' table and blend: "exact", "fast" or "bf16"

    @property
    def exact_box(self) -> str:
        """The box argument of render_grad and of the oracle (which take the
        eps boxes from cull_eps): "tight" for the tight box, else "reference"."""
        return "tight" if self.box == "tight" else "reference"

    def diff_args(self) -> dict:
        """render_grad's keyword arguments for this tier (box_tier's inverse
        for an exact-walk tier): box, cull_eps and corner_cull."""
        return dict(box=self.exact_box, cull_eps=self.eps, corner_cull=self.corner_eps is not None)


def tier(precision: str, cull_eps: Optional[float] = None, corner_cull: bool = False) -> Tier:
    """The tier of a precision string: "highest" walks exact over the
    reference box, "exact-tight" over the tight box; "fast" walks K3 over
    the eps-tight boxes at cull_eps (None: the default), corner-culled at
    the same eps when corner_cull; "bf16" is the reference box with the
    bf16 fitness walk (its canvas walk and earlier passes are the exact
    ones). Raises ValueError for an unknown precision."""
    render_cuda._check_precision(precision)
    if precision == "fast":
        eps = render_cuda._eps(cull_eps)
        return Tier("eps", eps, eps if corner_cull else None, "fast")
    if precision == "exact-tight":
        return Tier("tight", None, None, "exact")
    return Tier("reference", None, None, "bf16" if precision == "bf16" else "exact")


def box_tier(box: str, cull_eps: Optional[float] = None, corner_cull: bool = False) -> Tier:
    """The tier of render_grad's arguments: the eps-tight boxes when
    cull_eps is set (they subsume the box tier's), with the corner cull at
    that eps when corner_cull (and only with cull_eps); else `box`,
    "reference" or "tight". The walk is always the exact one."""
    if box not in ("reference", "tight"):
        raise ValueError(f"unknown box {box!r}")
    if cull_eps is None:
        return Tier(box, None, None, "exact")
    eps = float(cull_eps)
    return Tier("eps", eps, eps if corner_cull else None, "exact")


def screen(g9: torch.Tensor, H: int, W: int, k_sigma: float, t: Tier,
           y_origin: int = 0) -> codec.SplatScreen:
    """Renderer genomes [B, N, >= 9] -> screen-space splats with the tier's
    boxes. A row slab (y_origin > 0) preprocesses against the whole (H, W)
    canvas, shifts cy, y0 and y1 up by y_origin (render_cuda.shift_rows) and
    only then takes the tier's boxes (render_pallas.py:1527-1539,
    render_grad.py:781-800). Differentiable in the genomes."""
    with profiling.span("render.screen"):
        p = codec.preprocess(g9[..., : codec.GENE_DIM].to(torch.float32), H, W, k_sigma)
        p = render_cuda.shift_rows(p, y_origin)
        if t.box == "eps":
            return render_cuda._tighten_boxes(p, k_sigma, t.eps)
        if t.box == "tight":
            return codec.tighten_boxes_exact(p, k_sigma)
        return p


def passes(p: codec.SplatScreen) -> List[codec.SplatScreen]:
    """The screens of the passes the walks chain (render_cuda._chunk_bounds:
    ceil(N / MAX_SPLATS) of them, at least one), in painter order; p itself
    when there is one."""
    bounds = render_cuda._chunk_bounds(p.cx.shape[1])
    if len(bounds) == 2:
        return [p]
    return [render_cuda._split_screen(p, lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]
