"""Tiled rasterizer: screen-space tables, boxes and culls, dense binning,
and the walk kernels (K1/K2 exact, K3 fast, K1-bf16) and the fast table
builder (K4), each with its plain PyTorch version.

PyTorch/CUDA counterpart of `ggs_tpu/ops/render_pallas.py`, single pass:

* Tables: `_splat_feats_fast` (render_pallas.py:189), the pre-folded exact
  table [B, 13, N+1] with a no-op sentinel column N, and
  `_splat_feats_turbo` (:220), the fast tier's log2e-folded table with
  log2(alpha) and open-interval thresholds.
* Boxes and culls of the fast tier (plain PyTorch: XLA code in the JAX
  package): `_tighten_boxes` (:377), the eps-tight boxes;
  `_corner_eps`/`_corner_params`/`_corner_keep` (:411-486), the rect-min
  corner cull; `bin_splats_dense` (:659), per-tile ascending splat lists
  padded with N, counts capped at `bin_capacity`, with the corner cull
  ANDed in where `_bin_splats_dense` does.
* Kernel wrappers, each with a launch count and a plain version beside it
  (a CPU tensor takes the plain version; a CUDA tensor launches the kernel
  or raises): `fitness_tiles` (K1), `render_tiles` (K2),
  `fitness_tiles_fast` / `render_tiles_fast` (K3), `fitness_tiles_bf16`
  (K1-bf16) and `prep_fast` (K4), all in `csrc/walk.cu`.
* `render` / `fitness`: the entry points, mirroring `render_pallas` and
  `fitness_pallas` for the four precision tiers. Fast fitness takes
  `fitness_pallas`'s single-chunk route (K4 -> dense binning with the
  corner parameters sliced from K4's table -> K3); fast render takes
  `preprocess` -> `_tighten_boxes` -> `_corner_params` -> K3. The two
  routes build their boxes by different rules, as in the JAX package, and
  may bin a splat differently. "bf16" fitness runs K1-bf16 over the
  reference box; "bf16" renders the exact walk. One pass: the JAX package
  chains passes through an init canvas only above 8000 splats, which this
  port does not do yet (a single pass composites the same splats in the
  same order; the bf16 fitness, whose chained passes are f32, raises).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence, Tuple

import torch

from . import codec, fitness as fitness_mod

# feats table rows (the kernel's parameter layout)
_F_CX, _F_CY, _F_SXX, _F_SXY, _F_SYY, _F_R, _F_G, _F_B, _F_A = range(9)
_F_X0, _F_X1, _F_Y0, _F_Y1 = 9, 10, 11, 12
_NFEAT = 13

PRECISIONS = ("highest", "exact-tight", "fast", "bf16")
DEFAULT_CULL_EPS = 2e-3  # the fast tier's cull eps when none is given
_LOG2E = 1.4426950408889634
_MODES = {"exact": 0, "fast": 1, "bf16": 2}  # walk.cu's blend modes
# the JAX package's one-pass limit (render_pallas._MAX_SMEM_SPLATS): above it
# it chains passes, and fast fitness leaves K4's single-chunk route
MAX_SPLATS = 8000

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel sources, each built into its own library (walk_grad.cu holds the
# backward walks K6/K7 of ops/render_grad.py)
SOURCES = {
    "walk": os.path.join(_PKG_DIR, "csrc", "walk.cu"),
    "walk_grad": os.path.join(_PKG_DIR, "csrc", "walk_grad.cu"),
}
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ggs_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (one of {PRECISIONS})")


# ---------------------------------------------------------------- build


class _Kernels:
    """The loaded kernel libraries and the compiler's report for each."""

    def __init__(self, libs: dict, paths: dict, logs: dict):
        self.lib = lib = libs["walk"]
        self.grad = grad = libs["walk_grad"]
        self.paths = paths
        self.logs = logs
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ggs_walk_render.argtypes = [i, p, p, p, p] + [i] * 9 + [f, f, f, p]
        lib.ggs_walk_render.restype = i
        lib.ggs_walk_fitness.argtypes = [i, p, p, p, p, p, p] + [i] * 9 + [f, f, f, p]
        lib.ggs_walk_fitness.restype = i
        lib.ggs_prep_fast.argtypes = [p, p, p, i, i] + [f] * 5 + [p]
        lib.ggs_prep_fast.restype = i
        lib.ggs_walk_geometry_ok.argtypes = [i, i]
        lib.ggs_walk_geometry_ok.restype = i
        lib.ggs_error_string.argtypes = [i]
        lib.ggs_error_string.restype = ctypes.c_char_p
        grad.ggs_grad_walk.argtypes = (
            [i, p, p, p, p, p, p, f, p, p, p, p] + [i] * 10 + [f, f, f, p]
        )
        grad.ggs_grad_walk.restype = i
        grad.ggs_grad_resident_blocks.argtypes = [i]
        grad.ggs_grad_resident_blocks.restype = i
        for fn in ("ggs_grad_tile_h", "ggs_grad_tile_w", "ggs_grad_chunk"):
            getattr(grad, fn).argtypes = []
            getattr(grad, fn).restype = i

    def check(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self.lib.ggs_error_string(rc).decode()
            raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


_KERNELS: Optional[_Kernels] = None


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def build() -> _Kernels:
    """Compile every source in SOURCES with nvcc for sm_90a (once per source
    hash, into build/ggs_tpu_torch/; one nvcc per source, all started
    together) and load them. A failed build raises with nvcc's stderr;
    `.logs` holds ptxas' register/shared-memory/spill report per source."""
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, jobs = {}, []
    try:
        for name, src in SOURCES.items():
            with open(src, "rb") as fh:
                tag = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            so = paths[name] = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
            if not os.path.exists(so):
                nvcc = _nvcc()
                fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
                os.close(fd)
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
                jobs.append((src, so, tmp, proc))
        failed = []
        for src, so, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {src} (exit {proc.returncode}):\n{err}")
                continue
            with open(so + ".log", "w") as fh:
                fh.write(out + err)
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    logs = {}
    for name, so in paths.items():
        logs[name] = ""
        if os.path.exists(so + ".log"):
            with open(so + ".log") as fh:
                logs[name] = fh.read()
    libs = {name: ctypes.CDLL(so) for name, so in paths.items()}
    _KERNELS = _Kernels(libs, paths, logs)
    return _KERNELS


# ------------------------------------------------------------- tables


def _splat_feats_fast(p: codec.SplatScreen) -> torch.Tensor:
    """Parameter table [B, 13, N+1] f32 with the constants pre-folded:
    rows 2-4 hold (-0.5*sxx, -sxy, -0.5*syy), exact power-of-two scalings,
    so the walk computes exp(quad') with every f32 intermediate equal to
    the unfolded form. Column N is a sentinel (alpha 0, inverted AABB)."""
    B, N = p.cx.shape
    feats = torch.stack(
        [
            p.cx, p.cy, -0.5 * p.sxx, -p.sxy, -0.5 * p.syy,
            p.rc, p.gc, p.bc, p.a,
            p.x0.to(torch.float32), p.x1.to(torch.float32),
            p.y0.to(torch.float32), p.y1.to(torch.float32),
        ],
        dim=1,
    )
    sentinel = torch.zeros((B, _NFEAT, 1), dtype=torch.float32, device=feats.device)
    sentinel[:, _F_X0, 0] = 1e9
    sentinel[:, _F_X1, 0] = -1e9
    return torch.cat([feats, sentinel], dim=2).contiguous()


def _log2_alpha(a: torch.Tensor) -> torch.Tensor:
    """log2(alpha), -inf for alpha 0 (exp2(-inf) = 0 exactly)."""
    return torch.where(a > 0.0, torch.log2(torch.clamp_min(a, 1e-38)), float("-inf"))


def _splat_feats_turbo(p: codec.SplatScreen) -> torch.Tensor:
    """The fast tier's table [B, 13, N+1] f32 (render_pallas.py:220): rows
    2-4 fold -0.5*log2(e) (-log2(e) for the cross term) into the precision
    entries, row 8 holds log2(alpha), rows 9-12 the open-interval
    thresholds x0-1, x1+1, y0-1, y1+1. Sentinel column N: row 8 -inf,
    X0 1e9, X1 -1e9, Y0 = Y1 = 0."""
    B, N = p.cx.shape
    feats = torch.stack(
        [
            p.cx, p.cy,
            (-0.5 * _LOG2E) * p.sxx, (-_LOG2E) * p.sxy, (-0.5 * _LOG2E) * p.syy,
            p.rc, p.gc, p.bc, _log2_alpha(p.a),
            p.x0.to(torch.float32) - 1.0, p.x1.to(torch.float32) + 1.0,
            p.y0.to(torch.float32) - 1.0, p.y1.to(torch.float32) + 1.0,
        ],
        dim=1,
    )
    sentinel = torch.zeros((B, _NFEAT, 1), dtype=torch.float32, device=feats.device)
    sentinel[:, _F_A, 0] = float("-inf")
    sentinel[:, _F_X0, 0] = 1e9
    sentinel[:, _F_X1, 0] = -1e9
    return torch.cat([feats, sentinel], dim=2).contiguous()


# ------------------------------------------------ fast-tier boxes and culls


def _eps(cull_eps: Optional[float]) -> float:
    """The one place None becomes the default cull eps."""
    return DEFAULT_CULL_EPS if cull_eps is None else float(cull_eps)


@torch.no_grad()
def _tighten_boxes(
    p: codec.SplatScreen, k_sigma: float, cull_eps: Optional[float] = None
) -> codec.SplatScreen:
    """The fast tier's eps-tight boxes (render_pallas.py:377): the
    r_eff-sigma extents, r_eff = min(k, sqrt(2 ln(alpha / eps))), of the
    covariance recovered from the precision entries, intersected with the
    incoming box; splats with alpha <= eps get the empty box x0=1, x1=-1
    (which empties their tile range too)."""
    eps = _eps(cull_eps)
    det = p.sxx * p.syy - p.sxy * p.sxy
    cov_xx = p.syy / det
    cov_yy = p.sxx / det
    r2 = 2.0 * (torch.log(torch.clamp_min(p.a, 1e-38)) - math.log(eps))
    r = torch.clamp_max(torch.sqrt(torch.clamp_min(r2, 0.0)), k_sigma)
    hx = torch.clamp_min(r * torch.sqrt(torch.clamp_min(cov_xx, 0.0)), 1.0)
    hy = torch.clamp_min(r * torch.sqrt(torch.clamp_min(cov_yy, 0.0)), 1.0)
    live = p.a > eps
    x0 = torch.maximum(p.x0, codec._to_i32(torch.floor(p.cx - hx)))
    x1 = torch.minimum(p.x1, codec._to_i32(torch.ceil(p.cx + hx)))
    y0 = torch.maximum(p.y0, codec._to_i32(torch.floor(p.cy - hy)))
    y1 = torch.minimum(p.y1, codec._to_i32(torch.ceil(p.cy + hy)))
    x0 = torch.where(live, x0, torch.ones_like(x0))
    x1 = torch.where(live, x1, torch.full_like(x1, -1))
    return p._replace(x0=x0, x1=x1, y0=y0, y1=y1)


def _corner_eps(precision: str, corner_cull: bool, cull_eps: Optional[float]) -> Optional[float]:
    """The corner cull's eps: only in the fast tier, at the box cull's eps."""
    if precision != "fast" or not corner_cull:
        return None
    return _eps(cull_eps)


@torch.no_grad()
def _corner_params(p: codec.SplatScreen, cull_eps: Optional[float]) -> tuple:
    """SplatScreen -> the corner cull's (cx, cy, nsxx, nsxy, nsyy, log2a,
    log2eps): the log2-folded quadratic the fast walk evaluates."""
    return (
        p.cx, p.cy, (-0.5 * _LOG2E) * p.sxx, (-_LOG2E) * p.sxy, (-0.5 * _LOG2E) * p.syy,
        _log2_alpha(p.a), math.log2(_eps(cull_eps)),
    )


def _corner_keep(corner, x0, x1, y0, y1, t_x, t_y, tile_h: int, tile_w: int) -> torch.Tensor:
    """Rect-min corner cull [B, T, N] (render_pallas.py:439): keep a (tile,
    splat) pair iff the splat's largest log2-contribution over the pair's
    pixel rect (tile ∩ box) reaches log2(eps). The maximum of the concave
    quadratic lies on the two rect edges nearest the centre, each taken at
    its clamped vertex; the same expressions in the same order as JAX."""
    cx, cy, nsxx, nsxy, nsyy, log2a, log2eps = corner
    f32 = lambda v: v.to(torch.float32)  # noqa: E731
    cxe, cye = cx[:, None, :], cy[:, None, :]
    dx0 = torch.maximum(f32(t_x * tile_w), f32(x0[:, None, :])) - cxe
    dx1 = torch.minimum(f32(t_x * tile_w + (tile_w - 1)), f32(x1[:, None, :])) - cxe
    dy0 = torch.maximum(f32(t_y * tile_h), f32(y0[:, None, :])) - cye
    dy1 = torch.minimum(f32(t_y * tile_h + (tile_h - 1)), f32(y1[:, None, :])) - cye
    nxx, nxy, nyy = nsxx[:, None, :], nsxy[:, None, :], nsyy[:, None, :]
    rx = (-0.5) * nsxy / torch.clamp_max(nsxx, -1e-30)
    ry = (-0.5) * nsxy / torch.clamp_max(nsyy, -1e-30)
    # nearest-x edge: dx = clamp(0), dy = the clamped vertex of n(dxc, .)
    dxc = torch.minimum(torch.clamp_min(dx0, 0.0), dx1)
    dyv = torch.minimum(torch.maximum(ry[:, None, :] * dxc, dy0), dy1)
    v1 = (nxx * dxc + nxy * dyv) * dxc + nyy * dyv * dyv
    # nearest-y edge, symmetric
    dyc = torch.minimum(torch.clamp_min(dy0, 0.0), dy1)
    dxv = torch.minimum(torch.maximum(rx[:, None, :] * dyc, dx0), dx1)
    v2 = (nyy * dyc + nxy * dxv) * dyc + nxx * dxv * dxv
    return log2a[:, None, :] + torch.maximum(v1, v2) >= log2eps


@torch.no_grad()
def bin_splats_dense(
    x0, x1, y0, y1, n_tx: int, n_ty: int, tile_h: int, tile_w: int, cap: int, corner=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABBs [B, N] int32 -> (bin_idx [B, T, cap] int32 ascending, padded
    with N; cnt [B, T] int32 = min(count, cap)). A tile keeps the first cap
    indices of its list when more overlap it. `corner` (the fast tier's
    `_corner_params`) ANDs in the corner cull."""
    B, N = x0.shape
    dev = x0.device
    tx0 = torch.div(x0, tile_w, rounding_mode="floor")
    tx1 = torch.div(x1, tile_w, rounding_mode="floor")
    ty0 = torch.div(y0, tile_h, rounding_mode="floor")
    ty1 = torch.div(y1, tile_h, rounding_mode="floor")

    T = n_ty * n_tx
    t_ids = torch.arange(T, dtype=torch.int32, device=dev)
    t_x = (t_ids % n_tx)[None, :, None]  # [1, T, 1]
    t_y = (t_ids // n_tx)[None, :, None]
    ov = (
        (tx0[:, None, :] <= t_x)
        & (tx1[:, None, :] >= t_x)
        & (ty0[:, None, :] <= t_y)
        & (ty1[:, None, :] >= t_y)
    )  # [B, T, N]
    if corner is not None:
        ov &= _corner_keep(corner, x0, x1, y0, y1, t_x, t_y, tile_h, tile_w)
    ar = torch.arange(N, dtype=torch.int32, device=dev)[None, None, :]
    order = torch.where(ov, ar, torch.full((), N, dtype=torch.int32, device=dev))
    bin_idx = torch.sort(order, dim=-1).values[..., :cap].contiguous()
    cnt = torch.clamp_max(torch.sum(ov, dim=-1, dtype=torch.int32), cap)
    return bin_idx, cnt


# ------------------------------------------------------ plain versions


def prep_fast_plain(g9: torch.Tensor, H: int, W: int, k_sigma: float, cull_eps=None):
    """Plain version of K4 (render_pallas._prep_turbo_kernel): renderer
    genomes [B, N, 9] -> (ff [B, 13, N+1] f32, the fast table; fi [B, 4, N]
    int32, the eps-tight boxes x0, x1, y0, y1). The boxes come from l11,
    l21, l22 directly (clipped to the canvas, then floor/ceil), not from
    preprocess' box; alpha <= eps gives x0=1, x1=-1. Its sentinel differs
    from _splat_feats_turbo's: rows 9 and 11 are 1e9, rows 10 and 12 -1e9."""
    B, N, _ = g9.shape
    maxx, maxy = float(W - 1), float(H - 1)
    eps = _eps(cull_eps)
    g = g9.to(torch.float32)
    inv255 = 1.0 / 255.0
    cx = torch.clamp(g[..., 0], 0.0, 1.0) * maxx
    cy = torch.clamp(g[..., 1], 0.0, 1.0) * maxy
    l11 = torch.clamp_min(torch.exp(g[..., 2]), 1e-6)
    l22 = torch.clamp_min(torch.exp(g[..., 3]), 1e-6)
    l21 = g[..., 4]
    a = torch.clamp(g[..., 8], 0.0, 255.0) * inv255
    r2 = 2.0 * (torch.log(torch.clamp_min(a, 1e-38)) - math.log(eps))
    r = torch.clamp_max(torch.sqrt(torch.clamp_min(r2, 0.0)), k_sigma)
    hx = torch.clamp_min(r * l11, 1.0)
    hy = torch.clamp_min(r * torch.sqrt(l21 * l21 + l22 * l22), 1.0)
    live = a > eps
    x0 = torch.where(live, torch.floor(torch.clamp(cx - hx, 0.0, maxx)), 1.0)
    x1 = torch.where(live, torch.ceil(torch.clamp(cx + hx, 0.0, maxx)), -1.0)
    y0 = torch.floor(torch.clamp(cy - hy, 0.0, maxy))
    y1 = torch.ceil(torch.clamp(cy + hy, 0.0, maxy))
    inv11 = 1.0 / l11
    inv22 = 1.0 / l22
    inv21 = -l21 * (inv11 * inv22)
    rows = [
        cx, cy,
        (-0.5 * _LOG2E) * (inv11 * inv11 + inv21 * inv21),
        (-_LOG2E) * (inv21 * inv22),
        (-0.5 * _LOG2E) * (inv22 * inv22),
        torch.clamp(g[..., 5], 0.0, 255.0) * inv255,
        torch.clamp(g[..., 6], 0.0, 255.0) * inv255,
        torch.clamp(g[..., 7], 0.0, 255.0) * inv255,
        _log2_alpha(a),
        x0 - 1.0, x1 + 1.0, y0 - 1.0, y1 + 1.0,
    ]
    sentinel = torch.zeros((B, _NFEAT, 1), dtype=torch.float32, device=g.device)
    sentinel[:, _F_A, 0] = float("-inf")
    sentinel[:, [_F_X0, _F_Y0], 0] = 1e9
    sentinel[:, [_F_X1, _F_Y1], 0] = -1e9
    ff = torch.cat([torch.stack(rows, dim=1), sentinel], dim=2).contiguous()
    fi = torch.stack([x0, x1, y0, y1], dim=1).to(torch.int32).contiguous()
    return ff, fi


def _walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, mode="exact"):
    """The walk in plain PyTorch over the same lists: slot k of every
    (candidate, tile) list at once, blended where k < cnt. Returns the
    clamped (r, g, b) planes, each [B, T, tile_h, tile_w] f32.

    mode "exact": f = exp(sum left to right) * a over the closed box,
    C = (1 - f) C + f c. "fast" (the turbo table): f = exp2(nsxx qx^2 +
    (nsxy qx qy + (nsyy qy^2 + log2a))) over the open thresholds,
    C = C + f (c - C). "bf16": the exact walk with qx, qy cast to bf16
    after the f32 subtraction and every later operation in bf16, on a bf16
    canvas (render_pallas.py:1123-1165)."""
    B, T, _ = idx.shape
    dev = feats.device
    t = torch.arange(T, device=dev)
    xf = ((t % n_tx) * tile_w)[:, None, None] + torch.arange(tile_w, device=dev)[None, None, :]
    yf = ((t // n_tx) * tile_h)[:, None, None] + torch.arange(tile_h, device=dev)[None, :, None]
    xf = xf.to(torch.float32)[None]  # [1, T, 1, tw]
    yf = yf.to(torch.float32)[None]  # [1, T, th, 1]
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    canvas = [
        torch.full((B, T, tile_h, tile_w), float(c), dtype=dt, device=dev) for c in background
    ]
    kmax = int(cnt.max()) if cnt.numel() else 0
    zero = torch.zeros((), dtype=dt, device=dev)
    for k in range(kmax):
        s = idx[:, :, k].long()  # [B, T]
        pk = torch.gather(feats, 2, s[:, None, :].expand(B, _NFEAT, T))  # [B, 13, T]
        cx, cy, nsxx, nsxy, nsyy, rc, gc, bc, a, x0, x1, y0, y1 = (
            pk[:, r, :, None, None] for r in range(_NFEAT)
        )
        qx = xf - cx
        qy = yf - cy
        live = (k < cnt)[:, :, None, None]
        if mode == "fast":
            f = torch.exp2(nsxx * (qx * qx) + (nsxy * (qx * qy) + (nsyy * (qy * qy) + a)))
            m = (xf > x0) & (xf < x1) & (yf > y0) & (yf < y1) & live
            f = torch.where(m, f, zero)
            canvas = [ch + f * (col - ch) for ch, col in zip(canvas, (rc, gc, bc))]
            continue
        if mode == "bf16":
            qx, qy = qx.to(dt), qy.to(dt)
            nsxx, nsxy, nsyy, a = (v.to(dt) for v in (nsxx, nsxy, nsyy, a))
            rc, gc, bc = (v.to(dt) for v in (rc, gc, bc))
        quad = nsxx * (qx * qx) + nsxy * (qx * qy) + nsyy * (qy * qy)
        f = torch.exp(quad) * a
        m = (xf >= x0) & (xf <= x1) & (yf >= y0) & (yf <= y1) & live
        f = torch.where(m, f, zero)
        one_m_f = 1.0 - f
        canvas = [one_m_f * ch + f * col for ch, col in zip(canvas, (rc, gc, bc))]
    return tuple(torch.clamp(ch.to(torch.float32), 0.0, 1.0) for ch in canvas)


def _tiles_of(plane: torch.Tensor, n_tx: int, tile_h: int, tile_w: int) -> torch.Tensor:
    """[..., Hp, Wp] -> [..., T, tile_h, tile_w] in tile order t = ty*n_tx + tx."""
    *lead, Hp, Wp = plane.shape
    n_ty = Hp // tile_h
    x = plane.reshape(*lead, n_ty, tile_h, n_tx, tile_w).transpose(-3, -2)
    return x.reshape(*lead, n_ty * n_tx, tile_h, tile_w)


def render_tiles_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, Hp, Wp, mode="exact"):
    """Plain version of K2 (mode "exact") and K3's canvas (mode "fast"):
    the clamped canvas [B, 3, Hp, Wp]."""
    B, T, _ = idx.shape
    n_ty = T // n_tx
    planes = torch.stack(_walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, mode), 1)
    planes = planes.reshape(B, 3, n_ty, n_tx, tile_h, tile_w).transpose(3, 4)
    return planes.reshape(B, 3, Hp, Wp)


def fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background,
                        mode="exact"):
    """Plain version of K1 (mode "exact"), K3's fitness ("fast") and K1-bf16
    ("bf16"): partials [B, T] = sum_px w * sum_ch (C - target)^2, in f32."""
    cr, cg, cb = _walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, mode)
    tt = _tiles_of(target_p, n_tx, tile_h, tile_w)  # [3, T, th, tw]
    wt = _tiles_of(w_p, n_tx, tile_h, tile_w)  # [T, th, tw]
    dr = cr - tt[0]
    dg = cg - tt[1]
    db = cb - tt[2]
    return torch.sum((dr * dr + dg * dg + db * db) * wt, dim=(-2, -1))


# ------------------------------------------------------------ wrappers


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_lists(cnt, idx, feats, n_tx, tile_h, tile_w):
    B, T, L = idx.shape
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"feats is on {dev}; the kernel takes CUDA tensors")
    _require(cnt, "cnt", torch.int32, (B, T), dev)
    _require(idx, "idx", torch.int32, (B, T, L), dev)
    _require(feats, "feats", torch.float32, (B, _NFEAT, feats.shape[2]), dev)
    if T % n_tx:
        raise ValueError(f"T={T} is not a multiple of n_tx={n_tx}")
    if not build().lib.ggs_walk_geometry_ok(tile_h, tile_w):
        raise ValueError(f"tile {tile_h}x{tile_w} does not fit the kernel's block")
    return B, T, L, dev


def _render_launch(mode, what, cnt, idx, feats, n_tx, tile_h, tile_w, background):
    """One launch of walk.cu's canvas epilogue in blend mode `mode`."""
    B, T, L, dev = _check_lists(cnt, idx, feats, n_tx, tile_h, tile_w)
    Hp, Wp = (T // n_tx) * tile_h, n_tx * tile_w
    out = torch.empty((B, 3, Hp, Wp), dtype=torch.float32, device=dev)
    k = build()
    with torch.cuda.device(dev):
        rc = k.lib.ggs_walk_render(
            _MODES[mode], cnt.data_ptr(), idx.data_ptr(), feats.data_ptr(), out.data_ptr(),
            B, T, L, feats.shape[2], n_tx, tile_h, tile_w, Hp, Wp,
            *(float(c) for c in background), torch.cuda.current_stream(dev).cuda_stream,
        )
    k.check(rc, what)
    return out


def _fitness_launch(mode, what, cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background):
    """One launch of walk.cu's fitness epilogue in blend mode `mode`."""
    B, T, L, dev = _check_lists(cnt, idx, feats, n_tx, tile_h, tile_w)
    Hp, Wp = (T // n_tx) * tile_h, n_tx * tile_w
    _require(target_p, "target_p", torch.float32, (3, Hp, Wp), dev)
    _require(w_p, "w_p", torch.float32, (Hp, Wp), dev)
    out = torch.empty((B, T), dtype=torch.float32, device=dev)
    k = build()
    with torch.cuda.device(dev):
        rc = k.lib.ggs_walk_fitness(
            _MODES[mode], cnt.data_ptr(), idx.data_ptr(), feats.data_ptr(), target_p.data_ptr(),
            w_p.data_ptr(), out.data_ptr(),
            B, T, L, feats.shape[2], n_tx, tile_h, tile_w, Hp, Wp,
            *(float(c) for c in background), torch.cuda.current_stream(dev).cuda_stream,
        )
    k.check(rc, what)
    return out


def _padded_hw(idx, n_tx, tile_h, tile_w):
    T = idx.shape[1]
    return (T // n_tx) * tile_h, n_tx * tile_w


def render_tiles(cnt, idx, feats, n_tx, tile_h, tile_w, background):
    """K2: lists + table -> clamped canvas [B, 3, Hp, Wp].

    Replaces ggs_tpu/ops/render_pallas.py:_render_tile_kernel (pallas_call
    in _render_padded). Bound by the walk's f32 arithmetic, about 30
    operations and one exp per (splat, pixel) pair; the canvas stays in
    registers for the whole walk and is written once (csrc/walk.cu)."""
    if feats.device.type == "cpu":
        Hp, Wp = _padded_hw(idx, n_tx, tile_h, tile_w)
        return render_tiles_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, Hp, Wp)
    out = _render_launch("exact", "render_tiles", cnt, idx, feats, n_tx, tile_h, tile_w, background)
    render_tiles.launches += 1
    return out


render_tiles.launches = 0


def render_tiles_fast(cnt, idx, feats, n_tx, tile_h, tile_w, background):
    """K3, canvas epilogue: lists + the fast table (_splat_feats_turbo) ->
    clamped canvas [B, 3, Hp, Wp].

    Replaces _render_tile_kernel with turbo=True (the walk
    _composite_tile.blend_one_turbo, render_pallas.py:1077). Bound as K2,
    with exp2f for expf and no alpha multiply (csrc/walk.cu, mode 1)."""
    if feats.device.type == "cpu":
        Hp, Wp = _padded_hw(idx, n_tx, tile_h, tile_w)
        return render_tiles_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, Hp, Wp,
                                  mode="fast")
    out = _render_launch("fast", "render_tiles_fast", cnt, idx, feats, n_tx, tile_h, tile_w,
                         background)
    render_tiles_fast.launches += 1
    return out


render_tiles_fast.launches = 0


def fitness_tiles(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background):
    """K1: lists + table + padded target [3, Hp, Wp] and weights [Hp, Wp]
    (0 on the padding) -> partials [B, T] of sum_px w * sum_ch (C - target)^2.

    Replaces ggs_tpu/ops/render_pallas.py:_fitness_tile_kernel (pallas_call
    in _fitness_partials). Bound by the walk's f32 arithmetic; the canvas
    never leaves registers, and the per-tile sum is fixed-order (no atomics),
    so the partials are the same bits on every run (csrc/walk.cu)."""
    if feats.device.type == "cpu":
        return fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background)
    out = _fitness_launch("exact", "fitness_tiles", cnt, idx, feats, target_p, w_p, n_tx, tile_h,
                          tile_w, background)
    fitness_tiles.launches += 1
    return out


fitness_tiles.launches = 0


def fitness_tiles_fast(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background):
    """K3, fitness epilogue: as K1 over the fast table (K4's ff or
    _splat_feats_turbo). Replaces _fitness_tile_kernel with turbo=True
    (render_pallas.py:1460); csrc/walk.cu, mode 1."""
    if feats.device.type == "cpu":
        return fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w,
                                   background, mode="fast")
    out = _fitness_launch("fast", "fitness_tiles_fast", cnt, idx, feats, target_p, w_p, n_tx,
                          tile_h, tile_w, background)
    fitness_tiles_fast.launches += 1
    return out


fitness_tiles_fast.launches = 0


def fitness_tiles_bf16(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background):
    """K1-bf16: as K1 over the exact table with the walk and canvas in bf16,
    each operation rounded to bf16 as torch rounds it, the loss epilogue in
    f32. Replaces _fitness_tile_kernel with compute_dtype=bfloat16
    (render_pallas.py:1367); csrc/walk.cu, mode 2."""
    if feats.device.type == "cpu":
        return fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w,
                                   background, mode="bf16")
    out = _fitness_launch("bf16", "fitness_tiles_bf16", cnt, idx, feats, target_p, w_p, n_tx,
                          tile_h, tile_w, background)
    fitness_tiles_bf16.launches += 1
    return out


fitness_tiles_bf16.launches = 0


def prep_fast(g9: torch.Tensor, H: int, W: int, k_sigma: float, cull_eps=None):
    """K4: renderer genomes [B, N, 9] -> (ff [B, 13, N+1], fi [B, 4, N] int32),
    as prep_fast_plain.

    Replaces ggs_tpu/ops/render_pallas.py:_prep_turbo_kernel (pallas_call in
    _prep_turbo_pallas). One thread per (candidate, splat) reads the genome
    in place (no transpose copy); a few dozen operations against 36 bytes in
    and 68 out a splat, so bytes and the launch bound it (csrc/walk.cu)."""
    if g9.device.type == "cpu":
        return prep_fast_plain(g9, H, W, k_sigma, cull_eps)
    B, N = g9.shape[0], g9.shape[1]
    _require(g9, "g9", torch.float32, (B, N, codec.GENE_DIM), g9.device)
    eps = _eps(cull_eps)
    ff = torch.empty((B, _NFEAT, N + 1), dtype=torch.float32, device=g9.device)
    fi = torch.empty((B, 4, N), dtype=torch.int32, device=g9.device)
    k = build()
    with torch.cuda.device(g9.device):
        rc = k.lib.ggs_prep_fast(
            g9.data_ptr(), ff.data_ptr(), fi.data_ptr(), B, N, float(W - 1), float(H - 1),
            float(k_sigma), eps, math.log(eps), torch.cuda.current_stream(g9.device).cuda_stream,
        )
    k.check(rc, "prep_fast")
    prep_fast.launches += 1
    return ff, fi


prep_fast.launches = 0


# -------------------------------------------------------- entry points


def _prepare(g9, H, W, k_sigma, precision, bin_capacity, tile_h, tile_w,
             cull_eps=None, corner_cull=False, fitness_route=False):
    """Renderer genomes -> (cnt, idx, feats, n_tx, n_ty) for one pass: the
    tier's boxes, lists and the table its walk reads. `fitness_route`: fast
    fitness at N <= MAX_SPLATS takes K4's table and boxes, with the corner
    parameters sliced from K4's rows 0-4 and 8 (fitness_pallas,
    render_pallas.py:1345-1355, 1411-1417); every other case builds the
    boxes from preprocess (`_tighten_boxes` in the fast tier)."""
    _check_precision(precision)
    if g9.dim() == 2:
        g9 = g9[None]
    B, N, C = g9.shape
    if C < codec.GENE_DIM:
        raise ValueError(f"expected >= 9 genome cols, got {C}")
    g9 = g9[..., : codec.GENE_DIM].to(torch.float32)
    n_tx = _cdiv(W, tile_w)
    n_ty = _cdiv(H, tile_h)
    cap = N if bin_capacity is None else min(bin_capacity, N)
    corner_eps = _corner_eps(precision, corner_cull, cull_eps)
    if fitness_route and precision == "fast" and N <= MAX_SPLATS:
        ff, fi = prep_fast(g9.contiguous(), H, W, k_sigma, cull_eps)
        corner = None
        if corner_eps is not None:
            corner = tuple(ff[:, r, :N] for r in (0, 1, 2, 3, 4, _F_A)) + (math.log2(corner_eps),)
        idx, cnt = bin_splats_dense(
            fi[:, 0], fi[:, 1], fi[:, 2], fi[:, 3], n_tx, n_ty, tile_h, tile_w, cap, corner=corner
        )
        return cnt, idx, ff, n_tx, n_ty
    p = codec.preprocess(g9, H, W, k_sigma)
    if precision == "fast":
        p = _tighten_boxes(p, k_sigma, cull_eps)
    elif precision == "exact-tight":
        p = codec.tighten_boxes_exact(p, k_sigma)
    corner = None if corner_eps is None else _corner_params(p, corner_eps)
    idx, cnt = bin_splats_dense(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, tile_h, tile_w, cap, corner)
    feats = _splat_feats_turbo(p) if precision == "fast" else _splat_feats_fast(p)
    return cnt, idx, feats, n_tx, n_ty


def pad_planes(target: torch.Tensor, w_eff: Optional[torch.Tensor], Hp: int, Wp: int):
    """target [H, W, 3] and w_eff [H, W] (None = ones) -> K1's zero-padded
    target [3, Hp, Wp] and weights [Hp, Wp]: padding pixels weigh 0."""
    H, W = target.shape[0], target.shape[1]
    dev = target.device
    target_p = torch.zeros((3, Hp, Wp), dtype=torch.float32, device=dev)
    target_p[:, :H, :W] = target.to(torch.float32).permute(2, 0, 1)
    w_p = torch.zeros((Hp, Wp), dtype=torch.float32, device=dev)
    w_p[:H, :W] = 1.0 if w_eff is None else w_eff
    return target_p, w_p


def render(
    g9: torch.Tensor,
    H: int,
    W: int,
    k_sigma: float = 3.0,
    background: Sequence[float] = (1.0, 1.0, 1.0),
    bin_capacity: Optional[int] = None,
    tile_h: int = 64,
    tile_w: int = 128,
    precision: str = "highest",
    cull_eps: Optional[float] = None,
    corner_cull: bool = False,
) -> torch.Tensor:
    """Renderer genomes [B, N, 9] (or [N, 9]) -> [B, H, W, 3] (render_pallas).
    "fast" walks K3 over the eps-tight boxes (and the corner cull when
    corner_cull); "bf16" renders the exact walk over the reference box."""
    squeeze = g9.dim() == 2
    cnt, idx, feats, n_tx, _ = _prepare(
        g9, H, W, k_sigma, precision, bin_capacity, tile_h, tile_w, cull_eps, corner_cull
    )
    bg = tuple(float(c) for c in background)
    walk = render_tiles_fast if precision == "fast" else render_tiles
    out = walk(cnt, idx, feats, n_tx, tile_h, tile_w, bg)
    img = out[:, :, :H, :W].permute(0, 2, 3, 1).contiguous()
    return img[0] if squeeze else img


def fitness(
    g9: torch.Tensor,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor],
    H: int,
    W: int,
    k_sigma: float = 3.0,
    background: Sequence[float] = (1.0, 1.0, 1.0),
    boost_only: bool = False,
    boost_beta: float = 1.0,
    bin_capacity: Optional[int] = None,
    tile_h: int = 64,
    tile_w: int = 128,
    precision: str = "highest",
    cull_eps: Optional[float] = None,
    corner_cull: bool = False,
) -> torch.Tensor:
    """Fused render + fitness: renderer genomes [B, N, 9] -> fitness [B]
    (fitness_pallas). Candidate canvases never reach device memory. The
    walk: K1 for the exact tiers, K3 for "fast", K1-bf16 for "bf16"."""
    if precision == "bf16" and g9.shape[-2] > MAX_SPLATS:
        raise NotImplementedError(
            f"bf16 fitness above {MAX_SPLATS} splats chains f32 passes through an init "
            "canvas, which is not ported yet"
        )
    cnt, idx, feats, n_tx, n_ty = _prepare(
        g9, H, W, k_sigma, precision, bin_capacity, tile_h, tile_w, cull_eps, corner_cull,
        fitness_route=True,
    )
    w_eff, denom = fitness_mod.weff_denom(weight_mask, boost_only, boost_beta, H, W)
    target_p, w_p = pad_planes(target, w_eff, n_ty * tile_h, n_tx * tile_w)
    walk = {"fast": fitness_tiles_fast, "bf16": fitness_tiles_bf16}.get(precision, fitness_tiles)
    partials = walk(
        cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w,
        tuple(float(c) for c in background),
    )
    return torch.sum(partials, dim=1) / denom  # a 0-d CPU denom is a scalar: no sync
