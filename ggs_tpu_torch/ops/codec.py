"""Genome codec: axes-angle <-> Cholesky <-> screen-space precision form.

PyTorch counterpart of `ggs_tpu/ops/codec.py`. Two flat [..., N, 9]
float32 encodings of a splat set:

* axes-angle genome (what the optimizers evolve):
  cols [x, y, a_log, b_log, theta, r, g, b, alpha];
* renderer genome: cols 2..4 hold the Cholesky factor (log l11, log l22, l21).

Every expression keeps the JAX package's order of operations (`/ 255.0`,
`inv21 = -l21 * (inv11 * inv22)`, the 1e-6/1e-12 clamps, the conservative
`hy = k(|l21| + |l22|)`), so the float32 results agree with it to the
last bit wherever the elementary functions do. Every clamp on a
differentiable path is `clip` or `torch.maximum`, which split the gradient
0.5/0.5 at a tie as `jnp.clip` and `jnp.maximum` do (`torch.clamp` passes
all of it), so gradients at the bounds, where projected Adam leaves genes,
agree with the JAX package's too.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import profiling

# Genome column indices.
X, Y, ALOG, BLOG, THETA, R, G, B, ALPHA = range(9)
GENE_DIM = 9

_EPS_CHOL = 1e-12
_EPS_EXP = 1e-6
# f32 -> i32 saturation bounds of XLA's convert (2**31 - 128 is the largest
# float32 below 2**31); torch's own cast of an out-of-range float is undefined.
_I32_LO = -2.0**31
_I32_HI = 2.0**31 - 128.0


_CONSTS: dict = {}


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of value v with like's dtype and device, made once, so
    the GA's and Adam's loops launch no fill kernel per clip."""
    key = (v, like.dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.full((), v, dtype=like.dtype, device=like.device)
    return t


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: min(max(x, lo), hi), with JAX's gradient at the bounds
    (half of it at a tie). The values equal torch.clamp's, so where autograd
    records nothing (the GA's evaluation) the one-kernel clamp computes them."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, _const(lo, x)), _const(hi, x))


def _maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """jnp.maximum(x, lo), with its gradient split at a tie."""
    return torch.maximum(x, _const(lo, x))


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with XLA's semantics: saturate, NaN -> 0."""
    return torch.nan_to_num(x, nan=0.0).clamp(_I32_LO, _I32_HI).to(torch.int32)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] (reference: modules/utils.py:11-12), with the
    floored remainder computed as jnp.remainder computes it."""
    x = theta + math.pi
    m = 2.0 * math.pi
    r = torch.fmod(x, m)
    r = torch.where((r != 0) & (r < 0), r + m, r)
    return r - math.pi


def axes_angle_to_cholesky(a_log, b_log, theta):
    """(log sx, log sy, theta) -> (log l11, log l22, l21) (encode.py:5-24)."""
    sigma_x = torch.exp(a_log)
    sigma_y = torch.exp(b_log)
    c = torch.cos(theta)
    s = torch.sin(theta)

    sxx = (sigma_x**2) * (c**2) + (sigma_y**2) * (s**2)
    sxy = (sigma_x**2 - sigma_y**2) * s * c
    syy = (sigma_x**2) * (s**2) + (sigma_y**2) * (c**2)

    l11 = torch.sqrt(_maximum(sxx, _EPS_CHOL))
    l21 = sxy / l11
    l22 = torch.sqrt(_maximum(syy - l21 * l21, _EPS_CHOL))
    return torch.log(l11), torch.log(l22), l21


def genome_to_renderer(genome: torch.Tensor) -> torch.Tensor:
    """Axes-angle genome [..., N, 9] -> renderer genome [..., N, 9]."""
    with profiling.span("render.screen"):
        a_log_eff, b_log_eff, c_raw = axes_angle_to_cholesky(
            genome[..., ALOG], genome[..., BLOG], genome[..., THETA]
        )
        return torch.cat(
            [
                genome[..., X : Y + 1],
                a_log_eff[..., None],
                b_log_eff[..., None],
                c_raw[..., None],
                clip(genome[..., R : ALPHA + 1], 0.0, 255.0),
            ],
            dim=-1,
        )


class SplatScreen(NamedTuple):
    """Screen-space splat parameters (all [..., N])."""

    cx: torch.Tensor
    cy: torch.Tensor
    sxx: torch.Tensor  # precision-matrix entries (Sigma^-1)
    sxy: torch.Tensor
    syy: torch.Tensor
    rc: torch.Tensor  # colors in [0, 1]
    gc: torch.Tensor
    bc: torch.Tensor
    a: torch.Tensor  # opacity in [0, 1]
    x0: torch.Tensor  # integer AABB (int32, inclusive)
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor


def preprocess(g9: torch.Tensor, H: int, W: int, k_sigma: float) -> SplatScreen:
    """Renderer genome [..., N, 9] -> screen-space params (render.py:9-47)."""
    maxx = float(W - 1)
    maxy = float(H - 1)
    cx = clip(g9[..., X], 0.0, 1.0) * maxx
    cy = clip(g9[..., Y], 0.0, 1.0) * maxy

    l11 = _maximum(torch.exp(g9[..., ALOG]), _EPS_EXP)
    l22 = _maximum(torch.exp(g9[..., BLOG]), _EPS_EXP)
    l21 = g9[..., THETA]  # c_raw in renderer encoding

    # The half-extents feed only the integer boxes, which carry no gradient,
    # so torch.abs (gradient 0 at 0, where jnp.abs gives 1) is harmless here.
    hx = torch.clamp_min(k_sigma * torch.abs(l11), 1.0)
    hy = torch.clamp_min(k_sigma * (torch.abs(l21) + torch.abs(l22)), 1.0)

    x0 = torch.floor(torch.clamp(cx - hx, 0.0, maxx)).to(torch.int32)
    x1 = torch.ceil(torch.clamp(cx + hx, 0.0, maxx)).to(torch.int32)
    y0 = torch.floor(torch.clamp(cy - hy, 0.0, maxy)).to(torch.int32)
    y1 = torch.ceil(torch.clamp(cy + hy, 0.0, maxy)).to(torch.int32)

    inv11 = 1.0 / l11
    inv22 = 1.0 / l22
    inv21 = -l21 * (inv11 * inv22)
    sxx = inv11 * inv11 + inv21 * inv21
    sxy = inv21 * inv22
    syy = inv22 * inv22

    rc = clip(g9[..., R], 0.0, 255.0) / 255.0
    gc = clip(g9[..., G], 0.0, 255.0) / 255.0
    bc = clip(g9[..., B], 0.0, 255.0) / 255.0
    a = clip(g9[..., ALPHA], 0.0, 255.0) / 255.0

    return SplatScreen(cx, cy, sxx, sxy, syy, rc, gc, bc, a, x0, x1, y0, y1)


def tighten_boxes_exact(p: SplatScreen, k_sigma: float) -> SplatScreen:
    """Exact k-sigma ellipse AABB intersected with the preprocess box
    (precision="exact-tight"; codec.tighten_boxes_exact in the JAX package)."""
    det = p.sxx * p.syy - p.sxy * p.sxy
    hx = torch.clamp_min(k_sigma * torch.sqrt(torch.clamp_min(p.syy / det, 0.0)), 1.0)
    hy = torch.clamp_min(k_sigma * torch.sqrt(torch.clamp_min(p.sxx / det, 0.0)), 1.0)
    x0 = torch.maximum(p.x0, _to_i32(torch.floor(p.cx - hx)))
    x1 = torch.minimum(p.x1, _to_i32(torch.ceil(p.cx + hx)))
    y0 = torch.maximum(p.y0, _to_i32(torch.floor(p.cy - hy)))
    y1 = torch.minimum(p.y1, _to_i32(torch.ceil(p.cy + hy)))
    return p._replace(x0=x0, x1=x1, y0=y0, y1=y1)


def clamp_genome(
    genome: torch.Tensor, H: int, W: int, min_scale: float, max_scale: float
) -> torch.Tensor:
    """Clamp an axes-angle genome to its domain (modules/utils.py:36-45)."""
    max_side = float(max(H, W))
    lo = float(torch.log(torch.tensor(min_scale, dtype=torch.float32)))
    hi = float(torch.log(torch.tensor(max_scale * max_side, dtype=torch.float32)))
    return torch.cat(
        [
            torch.clamp(genome[..., X : Y + 1], 0.0, 1.0),
            torch.clamp(genome[..., ALOG : BLOG + 1], lo, hi),
            wrap_angle(genome[..., THETA])[..., None],
            torch.clamp(genome[..., R : ALPHA + 1], 0.0, 255.0),
        ],
        dim=-1,
    )


def scale_genome_pixels_anisotropic(genome: torch.Tensor, sH: float, sW: float) -> torch.Tensor:
    """Rescale pixel-space log-scales for a resolution change
    (modules/resize.py:16-20): a_log += log sW, b_log += log sH."""
    out = genome.clone()
    out[..., ALOG] += float(math.log(sW))
    out[..., BLOG] += float(math.log(sH))
    return out


def choose_work_size(Ht: int, Wt: int, max_side: int = 128) -> tuple[int, int]:
    """Scale so the longer side equals max_side exactly (modules/resize.py:6-13)."""
    if Ht >= Wt:
        Hf = max_side
        Wf = max(1, int(round(Wt * Hf / Ht)))
    else:
        Wf = max_side
        Hf = max(1, int(round(Ht * Wf / Wt)))
    return Hf, Wf
