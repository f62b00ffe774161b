"""The plain reference that decides `correct`: plain PyTorch, no kernel, no
part of the program.

From axes-angle genomes it works out again everything the program derives:
the renderer genome and screen-space splats (a frozen copy of
ggs_tpu_torch/ops/codec.py:90-210, the JAX package's order of operations
and its clip gradients), the exact-tight boxes (codec.py:193-203), the
importance mask (ggs_tpu_torch/ops/mask.py:20-132), the canvas composited
in painter order from a white background (the walk of
ggs_tpu_torch/ops/render_cuda.py:854-908, over each splat's closed integer
box, clamped to [0, 1]) and the masked SSE (ggs_tpu_torch/ops/fitness.py:
47-62). `value_and_grad` differentiates that energy by autograd, and
`follow_adam` takes torch.optim.Adam's steps (lr, betas, eps 1e-8) with
the genome domain's projection (codec.py:206-221), from fresh moments or
from a given genome, moments and step count.

`dtype=torch.bfloat16` computes the walk in bfloat16: the control that
has to come out as not correct.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

_EPS_CHOL = 1e-12
_EPS_EXP = 1e-6
_I32_LO, _I32_HI = -2.0**31, 2.0**31 - 128.0


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _clip(x, lo, hi):
    """jnp.clip, with half the gradient to each side at a tie."""
    return torch.minimum(torch.maximum(x, _c(lo, x)), _c(hi, x))


def _max(x, lo):
    return torch.maximum(x, _c(lo, x))


class Screen(NamedTuple):
    cx: torch.Tensor
    cy: torch.Tensor
    nsxx: torch.Tensor  # -0.5 * (Sigma^-1)_xx
    nsxy: torch.Tensor  # -(Sigma^-1)_xy
    nsyy: torch.Tensor  # -0.5 * (Sigma^-1)_yy
    col: torch.Tensor  # [..., N, 3] in [0, 1]
    a: torch.Tensor
    box: torch.Tensor  # [..., N, 4] int64: x0, x1, y0, y1, inclusive


def screen(g: torch.Tensor, H: int, W: int, k_sigma: float = 3.0) -> Screen:
    """Axes-angle genomes [..., N, 9] -> screen-space splats with the
    exact-tight boxes."""
    sx, sy = torch.exp(g[..., 2]), torch.exp(g[..., 3])
    c, s = torch.cos(g[..., 4]), torch.sin(g[..., 4])
    vxx = (sx**2) * (c**2) + (sy**2) * (s**2)
    vxy = (sx**2 - sy**2) * s * c
    vyy = (sx**2) * (s**2) + (sy**2) * (c**2)
    l11 = torch.sqrt(_max(vxx, _EPS_CHOL))
    l21 = vxy / l11
    l22 = torch.sqrt(_max(vyy - l21 * l21, _EPS_CHOL))
    a_log, b_log = torch.log(l11), torch.log(l22)

    maxx, maxy = float(W - 1), float(H - 1)
    cx = _clip(g[..., 0], 0.0, 1.0) * maxx
    cy = _clip(g[..., 1], 0.0, 1.0) * maxy
    e11 = _max(torch.exp(a_log), _EPS_EXP)
    e22 = _max(torch.exp(b_log), _EPS_EXP)
    hx = torch.clamp_min(k_sigma * torch.abs(e11), 1.0).detach()
    hy = torch.clamp_min(k_sigma * (torch.abs(l21) + torch.abs(e22)), 1.0).detach()
    cxd, cyd = cx.detach(), cy.detach()
    x0 = torch.floor(torch.clamp(cxd - hx, 0.0, maxx)).to(torch.int32)
    x1 = torch.ceil(torch.clamp(cxd + hx, 0.0, maxx)).to(torch.int32)
    y0 = torch.floor(torch.clamp(cyd - hy, 0.0, maxy)).to(torch.int32)
    y1 = torch.ceil(torch.clamp(cyd + hy, 0.0, maxy)).to(torch.int32)

    inv11, inv22 = 1.0 / e11, 1.0 / e22
    inv21 = -l21 * (inv11 * inv22)
    sxx = inv11 * inv11 + inv21 * inv21
    sxy = inv21 * inv22
    syy = inv22 * inv22
    col = _clip(_clip(g[..., 5:8], 0.0, 255.0), 0.0, 255.0) / 255.0
    a = _clip(_clip(g[..., 8], 0.0, 255.0), 0.0, 255.0) / 255.0

    # the tight k-sigma ellipse box inside the conservative one
    with torch.no_grad():
        det = sxx * syy - sxy * sxy
        tx = torch.clamp_min(k_sigma * torch.sqrt(torch.clamp_min(syy / det, 0.0)), 1.0)
        ty = torch.clamp_min(k_sigma * torch.sqrt(torch.clamp_min(sxx / det, 0.0)), 1.0)

        def i32(v):
            return torch.nan_to_num(v, nan=0.0).clamp(_I32_LO, _I32_HI).to(torch.int32)

        x0 = torch.maximum(x0, i32(torch.floor(cxd - tx)))
        x1 = torch.minimum(x1, i32(torch.ceil(cxd + tx)))
        y0 = torch.maximum(y0, i32(torch.floor(cyd - ty)))
        y1 = torch.minimum(y1, i32(torch.ceil(cyd + ty)))
    box = torch.stack([x0, x1, y0, y1], dim=-1).to(torch.int64)
    return Screen(cx, cy, -0.5 * sxx, -sxy, -0.5 * syy, col, a, box)


def clamp_genome(g: torch.Tensor, H: int, W: int, min_scale: float = 3.0,
                 max_scale: float = 0.1) -> torch.Tensor:
    """The genome domain (codec.clamp_genome): xy in [0, 1], log-scales in
    [log min_scale, log(max_scale * max(H, W))], theta wrapped to (-pi, pi],
    colour and alpha in [0, 255]."""
    lo = float(torch.log(torch.tensor(min_scale, dtype=torch.float32)))
    hi = float(torch.log(torch.tensor(max_scale * float(max(H, W)), dtype=torch.float32)))
    x = g[..., 4:5] + math.pi
    r = torch.fmod(x, 2.0 * math.pi)
    r = torch.where((r != 0) & (r < 0), r + 2.0 * math.pi, r)
    return torch.cat([g[..., 0:2].clamp(0.0, 1.0), g[..., 2:4].clamp(lo, hi), r - math.pi,
                      g[..., 5:9].clamp(0.0, 255.0)], dim=-1)


# ------------------------------------------------------------------ mask


def _to_unit(x):
    return torch.where(torch.max(x) > 1.5, x / 255.0, x)


def _resize(x_chw, H, W):
    if tuple(x_chw.shape[-2:]) == (H, W):
        return x_chw
    return F.interpolate(x_chw[None], size=(H, W), mode="bilinear", align_corners=False,
                         antialias=True)[0]


def _sobel(y):
    H, W = y.shape
    yp = F.pad(y, (1, 1, 1, 1))
    kx = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
    ky = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
    out = []
    for k in (kx, ky):
        acc = torch.zeros_like(y)
        for i in range(3):
            for j in range(3):
                if k[i][j] != 0.0:
                    acc = acc + k[i][j] * yp[i:i + H, j:j + W]
        out.append(acc)
    return torch.sqrt(out[0] * out[0] + out[1] * out[1] + 1e-12)


def _pool(y, k, stride, pad):
    return F.avg_pool2d(y[None, None], k, stride, pad, count_include_pad=True)[0, 0]


def _norm01(t):
    flat = t.reshape(-1)
    ql, qh = torch.quantile(flat, 0.02), torch.quantile(flat, 0.98)
    return torch.clamp((t - ql) / (qh - ql + 1e-12), 0.0, 1.0)


def importance_mask(target: torch.Tensor, H: int, W: int, edge_scales: Sequence[int] = (1, 2, 4),
                    w_edge: float = 0.7, w_var: float = 0.3, gamma: float = 0.7,
                    floor: float = 0.15, smooth: int = 3, strength: float = 0.7) -> torch.Tensor:
    """Target [H0, W0, 3] -> importance weights [H, W] (multi-scale Sobel
    edges and 9x9 local variance, 2%/98% normalised, blended, smoothed,
    gamma, floor and strength)."""
    x = _resize(_to_unit(target.to(torch.float32)).permute(2, 0, 1), H, W).permute(1, 2, 0)
    y = 0.2126 * x[..., 0] + 0.7152 * x[..., 1] + 0.0722 * x[..., 2]
    edges = torch.zeros_like(y)
    for s in edge_scales:
        if s > 1:
            yd = _pool(y, s, s, 0)[: H // s, : W // s]
            edges = edges + _resize(_sobel(yd)[None], H, W)[0]
        else:
            edges = edges + _sobel(y)
    mean, mean2 = _pool(y, 9, 1, 4), _pool(y * y, 9, 1, 4)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    m = _norm01(w_edge * _norm01(edges) + w_var * _norm01(var))
    if smooth and smooth > 0:
        m = _norm01(_pool(m, smooth, 1, smooth // 2))
    m = (1.0 - floor) * m**gamma + floor
    return (1.0 - strength) * torch.ones_like(m) + strength * m


# ------------------------------------------------------------------ canvas


def canvases(g: torch.Tensor, H: int, W: int, k_sigma: float = 3.0,
             dtype=torch.float32) -> torch.Tensor:
    """Genomes [K, N, 9] -> canvases [K, 3, H, W], every candidate at once,
    splat by splat in painter order (no gradient)."""
    with torch.no_grad():
        s = screen(g.to(torch.float32), H, W, k_sigma)
        K, N = s.cx.shape
        dev = g.device
        xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
        ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
        C = torch.ones((K, 3, H, W), dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        b = s.box
        for n in range(N):
            qx = (xs - s.cx[:, n, None, None]).to(dtype)
            qy = (ys - s.cy[:, n, None, None]).to(dtype)
            nsxx, nsxy, nsyy, a = (v[:, n, None, None].to(dtype)
                                   for v in (s.nsxx, s.nsxy, s.nsyy, s.a))
            quad = nsxx * (qx * qx) + nsxy * (qx * qy) + nsyy * (qy * qy)
            inside = ((xs >= b[:, n, 0, None, None]) & (xs <= b[:, n, 1, None, None])
                      & (ys >= b[:, n, 2, None, None]) & (ys <= b[:, n, 3, None, None]))
            f = torch.where(inside, torch.exp(quad) * a, zero)[:, None]
            col = s.col[:, n, :, None, None].to(dtype)
            C = (1.0 - f) * C + f * col
        return C.to(torch.float32).clamp(0.0, 1.0)


def _tile_numerator(s: Screen, ids: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    target, mask, dtype) -> torch.Tensor:
    """sum(w * sum_ch (C - t)^2) over one tile of the canvas (rows ys,
    columns xs) with the splats `ids` that reach it, in painter order:
    C = bg * prod_k (1 - f_k) + sum_k f_k c_k prod_{j > k} (1 - f_j)."""
    b = s.box[ids]
    qx = (xs[None, None, :] - s.cx[ids, None, None]).to(dtype)
    qy = (ys[None, :, None] - s.cy[ids, None, None]).to(dtype)
    quad = (s.nsxx[ids, None, None].to(dtype) * (qx * qx)
            + s.nsxy[ids, None, None].to(dtype) * (qx * qy)
            + s.nsyy[ids, None, None].to(dtype) * (qy * qy))
    x, y = xs[None, None, :], ys[None, :, None]
    inside = ((x >= b[:, 0, None, None]) & (x <= b[:, 1, None, None])
              & (y >= b[:, 2, None, None]) & (y <= b[:, 3, None, None]))
    f = torch.where(inside, torch.exp(quad) * s.a[ids, None, None].to(dtype),
                    torch.zeros((), dtype=dtype, device=xs.device))
    later = torch.flip(torch.cumprod(torch.flip(1.0 - f, [0]), 0), [0])  # prod_{j >= k}
    after = torch.cat([later[1:], torch.ones_like(later[:1])])  # prod_{j > k}
    col = s.col[ids].to(dtype)
    if len(ids):
        C = later[0][None] + torch.sum((f * after)[:, None] * col[:, :, None, None], dim=0)
        C = C.to(torch.float32).clamp(0.0, 1.0)
    else:  # the white background
        C = torch.ones((3, len(ys), len(xs)), device=xs.device)
    y0, x0 = int(ys[0]), int(xs[0])
    t = target[y0:y0 + len(ys), x0:x0 + len(xs)].permute(2, 0, 1)
    w = mask[y0:y0 + len(ys), x0:x0 + len(xs)]
    return torch.sum(torch.sum((C - t) ** 2, dim=0) * w)


def value_and_grad(g: torch.Tensor, target, mask, H: int, W: int, k_sigma: float = 3.0,
                   dtype=torch.float32, tile=(32, 128)):
    """One genome [N, 9] -> (energy, d energy / d g [N, 9]), the canvas taken
    a tile at a time with the splats whose boxes reach the tile."""
    x = g.detach().to(torch.float32).clone().requires_grad_(True)
    dev = g.device
    with torch.enable_grad():
        s = screen(x, H, W, k_sigma)
        fields = [s.cx, s.cy, s.nsxx, s.nsxy, s.nsyy, s.col, s.a]
        leaf = Screen(*[f.detach().requires_grad_(True) for f in fields], box=s.box)
        denom = float(torch.sum(mask)) + 1e-12
        th, tw = tile
        origins = [(y, x0) for y in range(0, H, th) for x0 in range(0, W, tw)]
        oy = torch.tensor([o[0] for o in origins], device=dev)
        ox = torch.tensor([o[1] for o in origins], device=dev)
        b = s.box
        reach = ((b[None, :, 0] <= ox[:, None] + tw - 1) & (b[None, :, 1] >= ox[:, None])
                 & (b[None, :, 2] <= oy[:, None] + th - 1) & (b[None, :, 3] >= oy[:, None]))
        reach = reach.cpu()
        num = torch.zeros((), dtype=torch.float64, device=dev)
        g_fields = [torch.zeros_like(f) for f in fields]
        for i, (y0, x0) in enumerate(origins):
            ids = torch.nonzero(reach[i]).reshape(-1).to(dev)
            ys = torch.arange(y0, min(H, y0 + th), dtype=torch.float32, device=dev)
            xs = torch.arange(x0, min(W, x0 + tw), dtype=torch.float32, device=dev)
            part = _tile_numerator(leaf, ids, ys, xs, target, mask, dtype) / denom
            num = num + part.detach().double()
            if ids.numel():
                got = torch.autograd.grad(part, list(leaf[:7]), allow_unused=True)
                g_fields = [a if d is None else a + d for a, d in zip(g_fields, got)]
        (grad,) = torch.autograd.grad(fields, x, g_fields)
    return float(num), grad


def masked_sse(imgs: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Canvases [K, 3, H, W], target [H, W, 3], mask [H, W] -> energies [K]:
    sum(w * sum_ch (C - t)^2) / (sum(w) + 1e-12)."""
    d2 = torch.sum((imgs - target.permute(2, 0, 1)[None]) ** 2, dim=1)
    return torch.sum(d2 * mask[None], dim=(1, 2)) / (torch.sum(mask) + 1e-12)


def energies(g: torch.Tensor, target, mask, H: int, W: int, k_sigma: float = 3.0,
             dtype=torch.float32, batch: int = 8) -> torch.Tensor:
    """Genomes [K, N, 9] -> masked-MSE energies [K] float64, `batch`
    candidates at a time."""
    out = [masked_sse(canvases(c, H, W, k_sigma, dtype), target, mask)
           for c in g.split(batch)]
    return torch.cat(out).double()


def follow_adam(g0: torch.Tensor, target, mask, H: int, W: int, steps: int, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, k_sigma: float = 3.0,
                dtype=torch.float32, moments=None, t0: int = 0):
    """`steps` projected Adam steps from g0 [N, 9], with fresh moments or
    `moments` (exp_avg, exp_avg_sq) after t0 steps -> (the energy before
    each step, the first step's gradient, the genome after the last step)."""
    g = g0.detach().to(torch.float32).clone()
    if moments is None:
        m, v = torch.zeros_like(g), torch.zeros_like(g)
    else:
        m, v = (x.detach().to(torch.float32).reshape(g.shape).clone() for x in moments)
    losses, first = [], None
    for t in range(t0 + 1, t0 + steps + 1):
        e, grad = value_and_grad(g, target, mask, H, W, k_sigma, dtype)
        losses.append(e)
        first = grad if first is None else first
        m = b1 * m + (1.0 - b1) * grad
        v = b2 * v + (1.0 - b2) * grad * grad
        step_size = lr / (1.0 - b1**t)
        denom = (v.sqrt() / math.sqrt(1.0 - b2**t)) + eps
        g = clamp_genome(g - step_size * m / denom, H, W)
    return losses, first, g
