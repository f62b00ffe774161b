"""Tiled rasterizer: screen-space tables, boxes and culls, binning, and the
walk kernels (K1/K2 exact, K3 fast, K1-bf16), the fast tier's table and
boxes (K4) and the scatter binning (K5), each with its plain PyTorch version.

PyTorch/CUDA counterpart of `ggs_tpu/ops/render_pallas.py`:

* Tables: `_splat_feats_fast` (render_pallas.py:189), the pre-folded exact
  table [B, 13, N+1] with a no-op sentinel column N, and
  `_splat_feats_turbo` (:220), the fast tier's log2e-folded table with
  log2(alpha) and open-interval thresholds.
* Boxes and culls of the fast tier (plain PyTorch: XLA code in the JAX
  package): `_tighten_boxes` (:377), the eps-tight boxes;
  `_corner_params`/`_corner_keep` (:411-486), the rect-min corner cull,
  and `_corner_band_xranges` (:489), its band-level form. Which of them a
  call takes is its tier's (ops/screen.py).
* Binning: `bin_splats` (`_bin_splats_xy`, :613) takes the route it
  plans once (`bin_route`). `bin_splats_dense` (:659): per-tile ascending
  splat lists padded with N, counts capped at `bin_capacity`, with the
  corner cull ANDed in. `bin_splats_scatter` (`_bin_splats_scatter`,
  :892): its static rules, then K5 from the boxes (the band lists and band
  ranges on the card); its plain route keeps `_band_lists`
  (`_band_lists_xla`, :698) and the band ranges in PyTorch. Under the
  corner cull the route is JAX's (K5 from 256 tiles, dense below), since
  it decides the lists; without it both give the same integers, and the
  card bins with K5 at every tile count its rules plan, the CPU densely
  below 256 tiles.
* Kernel wrappers, each counting its launches in `profiling.COUNTS` and
  with a plain version beside it (a CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises): `fitness_tiles` (K1),
  `render_tiles` (K2), `fitness_tiles_fast` / `render_tiles_fast` (K3),
  `fitness_tiles_bf16` (K1-bf16) and `prep_fast` (K4) in `csrc/walk.cu`;
  `bin_splats_scatter` (K5) in `csrc/scatter.cu`. Every walk takes an optional init canvas.
  `walk_path_counts` counts how the walks take a pass's lists, by path
  (for measurement; no walk calls it).
* `render` / `fitness`: the entry points, mirroring `render_pallas` and
  `fitness_pallas` for the four precision tiers (`screen.tier`). Above
  MAX_SPLATS splats they chain passes through the init canvas
  (`_chunked_passes`, :141), each pass binned on its own with its own
  capacity. Fast fitness at most MAX_SPLATS splats takes `fitness_pallas`'s
  single-chunk route (K4 -> binning with the corner parameters sliced from
  K4's table -> K3); every other case takes `screen.screen` (preprocess ->
  the tier's boxes) -> `_corner_params`.
  The two routes build their boxes by different rules, as in the JAX
  package, and may bin a splat differently. "bf16" fitness walks its
  earlier passes in f32 (K2) and its last in K1-bf16 over the reference
  box; "bf16" renders the exact walk.
* Row slabs, the building blocks of the tile-sharded paths:
  `fitness_partial` (`fitness_pallas_partial`, :1491) and `render_rows`
  (`render_rows_pallas`, :1556) preprocess against the whole canvas and
  shift into the slab (`shift_rows`) before the tier's boxes and culls;
  the same kernels then walk the slab's lists.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils import profiling
from . import codec, fitness as fitness_mod, screen

# feats table rows (the kernel's parameter layout)
_F_CX, _F_CY, _F_SXX, _F_SXY, _F_SYY, _F_R, _F_G, _F_B, _F_A = range(9)
_F_X0, _F_X1, _F_Y0, _F_Y1 = 9, 10, 11, 12
_NFEAT = 13

PRECISIONS = ("highest", "exact-tight", "fast", "bf16")
DEFAULT_CULL_EPS = 2e-3  # the fast tier's cull eps when none is given
_LOG2E = 1.4426950408889634
_MODES = {"exact": 0, "fast": 1, "bf16": 2}  # walk.cu's blend modes
# The pass size (render_pallas._MAX_SMEM_SPLATS). The card has no 1 MiB
# scalar-memory window to fit, but the chunking decides results: each pass
# keeps the first bin_capacity splats of its own chunk, and the bf16
# fitness walks every pass but the last in f32. It also bounds K6's replay
# scratch, which grows with the list length. Read through the module at
# call time (render_cuda.MAX_SPLATS), so that lowering it reaches every
# caller.
MAX_SPLATS = 8000
# The scatter binning's rules (render_pallas.py:640, :895, :44, :695). The
# budget was the TPU's scalar-memory room for one row group's lists; here it
# stays as a rule of the result, not a limit of the card: it sets the band
# height rpg and the list length cap_s, and so whether the corner cull is
# band-level or per tile, as in the JAX package. Read through the module at
# call time, as MAX_SPLATS is.
SCATTER_TILES = 256  # bin_splats scatters from this many tiles
SCATTER_BUDGET = 176 * 1024
SCATTER_PAD = 8  # the forward walks' pad_slots (render_grad passes 40)
_N_COARSE = 8  # coarse row bands

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel sources, each built into its own library (walk_grad.cu holds the
# backward walks K6/K7 of ops/render_grad.py, scatter.cu the binning K5)
SOURCES = {
    "walk": os.path.join(_PKG_DIR, "csrc", "walk.cu"),
    "walk_grad": os.path.join(_PKG_DIR, "csrc", "walk_grad.cu"),
    "scatter": os.path.join(_PKG_DIR, "csrc", "scatter.cu"),
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
        self.scatter = scatter = libs["scatter"]
        self.paths = paths
        self.logs = logs
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ggs_walk_render.argtypes = [i, p, p, p, p, p] + [i] * 9 + [f, f, f, p]
        lib.ggs_walk_render.restype = i
        lib.ggs_walk_fitness.argtypes = [i, p, p, p, p, p, p, p, p, p] + [i] * 9 + [f, f, f, p]
        lib.ggs_walk_fitness.restype = i
        lib.ggs_walk_blocks_per_sm.argtypes = [i, i]
        lib.ggs_walk_blocks_per_sm.restype = i
        lib.ggs_walk_sub_rows.argtypes = []
        lib.ggs_walk_sub_rows.restype = i
        lib.ggs_bf16x2_probe.argtypes = [i, p, p, p, i, p]
        lib.ggs_bf16x2_probe.restype = i
        scatter.ggs_scatter_bands.argtypes = [p] * 4 + [f] + [p] * 3 + [i] * 7 + [p]
        scatter.ggs_scatter_bands.restype = i
        scatter.ggs_scatter_tiles.argtypes = [p] * 4 + [f] + [p] * 5 + [i] * 10 + [p]
        scatter.ggs_scatter_tiles.restype = i
        lib.ggs_prep_fast.argtypes = [p, p, p, i, i] + [f] * 5 + [p]
        lib.ggs_prep_fast.restype = i
        lib.ggs_empty_launch.argtypes = [p]
        lib.ggs_empty_launch.restype = i
        lib.ggs_walk_geometry_ok.argtypes = [i, i]
        lib.ggs_walk_geometry_ok.restype = i
        lib.ggs_error_string.argtypes = [i]
        lib.ggs_error_string.restype = ctypes.c_char_p
        grad.ggs_grad_walk.argtypes = (
            [i, p, p, p, p, p, p, p, p, f, p, p, p, p, p, p, p] + [i] * 11 + [f, f, f, p]
        )
        grad.ggs_grad_walk.restype = i
        for fn in ("ggs_grad_resident_blocks", "ggs_grad_blocks_per_sm"):
            getattr(grad, fn).argtypes = [i]
            getattr(grad, fn).restype = i
        for fn in ("ggs_grad_sub_rows", "ggs_grad_chunk"):
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
    with profiling.span("render.feats"):
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
    with profiling.span("render.feats"):
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
def _corner_band_xranges(corner, x0, x1, y0, y1, band_px: int, tile_w: int):
    """The corner cull's band-level form (render_pallas.py:489): per coarse
    row band and splat, the tile-column interval [txl, txh] [B, 8, N] int32
    where the splat's peak log2-contribution over (band strip ∩ box) can
    reach log2(eps); txh = txl - 1 exactly when the interval is empty. With
    dy clamped to the band, max_dy of the quadratic is a concave piecewise
    quadratic in dx (pieces dy = dyl, the interior vertex, dy = dyh), whose
    superlevel set is the union of each piece's root interval within its
    domain. The same expressions in the same order as JAX."""
    cx, cy, nsxx, nsxy, nsyy, log2a, log2eps = corner
    f32 = torch.float32
    dev = cx.device
    big = torch.tensor(1e30, dtype=f32, device=dev)
    ex = lambda a: a[:, None, :]  # noqa: E731  [B, N] -> [B, 1, N]
    c = torch.arange(_N_COARSE, dtype=f32, device=dev)[None, :, None]
    dyl = torch.maximum(c * band_px, ex(y0.to(f32))) - ex(cy)
    dyh = torch.minimum(c * band_px + (band_px - 1), ex(y1.to(f32))) - ex(cy)
    nxx, nxy, nyy = ex(nsxx), ex(nsxy), ex(nsyy)
    L = log2eps - ex(log2a)  # need n(dx, dy) >= L

    def quad_interval(dyc):
        # {dx : nxx dx^2 + (nxy dyc) dx + nyy dyc^2 - L >= 0}, nxx < 0
        A = -nxx
        Bq = -nxy * dyc
        Cq = L - nyy * dyc * dyc
        D = Bq * Bq - 4.0 * A * Cq
        sq = torch.sqrt(torch.clamp_min(D, 0.0))
        inv2A = 0.5 / torch.clamp_min(A, 1e-30)
        lo = (-Bq - sq) * inv2A
        hi = (-Bq + sq) * inv2A
        empty = D < 0.0
        return torch.where(empty, big, lo), torch.where(empty, -big, hi)

    ry = nxy / (-2.0 * torch.clamp_max(nyy, -1e-30))  # dy*(dx) = ry dx

    def halfplane(cval, ge: bool):
        # the interval of {dx : ry dx >= cval} (ge) or {ry dx <= cval}
        rsafe = torch.where(torch.abs(ry) > 1e-20, ry, 1.0)
        q = torch.clamp(cval / rsafe, -1e30, 1e30)
        pos = ry > 1e-20
        neg = ry < -1e-20
        zero = ~(pos | neg)
        if ge:
            lo = torch.where(pos, q, -big)
            hi = torch.where(neg, q, big)
            dead = zero & (cval > 0.0)
        else:
            lo = torch.where(neg, q, -big)
            hi = torch.where(pos, q, big)
            dead = zero & (cval < 0.0)
        return torch.where(dead, big, lo), torch.where(dead, -big, hi)

    q0l, q0h = quad_interval(dyl)  # piece 0: dy clamped at dyl
    d0l, d0h = halfplane(dyl, ge=False)
    q2l, q2h = quad_interval(dyh)  # piece 2: dy clamped at dyh
    d2l, d2h = halfplane(dyh, ge=True)
    # piece 1: the interior vertex, m = qi dx^2 with qi = nxx - nxy^2/(4 nyy)
    qi = nxx - nxy * nxy / (4.0 * torch.clamp_max(nyy, -1e-30))
    R = torch.sqrt(torch.clamp_min(L / torch.clamp_max(qi, -1e-30), 0.0))
    q1l = torch.where(L <= 0.0, -R, big)
    q1h = torch.where(L <= 0.0, R, -big)
    d1l0, d1h0 = halfplane(dyl, ge=True)
    d1l1, d1h1 = halfplane(dyh, ge=False)
    d1l, d1h = torch.maximum(d1l0, d1l1), torch.minimum(d1h0, d1h1)

    ulo, uhi = big, -big
    for ql, qh, dl, dh in ((q0l, q0h, d0l, d0h), (q1l, q1h, d1l, d1h), (q2l, q2h, d2l, d2h)):
        plo = torch.maximum(ql, dl)
        phi = torch.minimum(qh, dh)
        keep = plo <= phi
        ulo = torch.minimum(ulo, torch.where(keep, plo, big))
        uhi = torch.maximum(uhi, torch.where(keep, phi, -big))
    band_hit = dyl <= dyh  # box ∩ band strip is not empty
    ulo = torch.where(band_hit, ulo, big)
    uhi = torch.where(band_hit, uhi, -big)

    x0f, x1f = ex(x0.to(f32)), ex(x1.to(f32))
    xlo = torch.clamp(torch.maximum(x0f, torch.floor(ex(cx) + ulo)), 0.0, 3.0e7)
    xhi = torch.clamp(torch.minimum(x1f, torch.ceil(ex(cx) + uhi)), -2.0, 3.0e7)
    txl = torch.div(xlo.to(torch.int32), tile_w, rounding_mode="floor")
    # empty => txh = txl - 1 exactly (K5 and the plain version test
    # txl <= tx <= txh; JAX's walk needs the column count to be 0)
    txh = torch.where(
        xhi < xlo, txl - 1, torch.div(xhi.to(torch.int32), tile_w, rounding_mode="floor")
    )
    return txl, txh


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


@torch.no_grad()
def _band_lists(ty0t, ty1t, n_ty: int, rpt: int, cap_g: int, keep=None):
    """Level 1 of the two-level scatter (`_band_lists_xla`,
    render_pallas.py:698): per coarse band of rpt tile rows, the ascending
    list of splats whose tile rows reach it (gl [B, 8, cap_g], padded with
    N) and its length (gcnt [B, 8, 1]). `keep` [B, 8, N] ANDs in the band
    corner cull's non-empty column ranges."""
    B, N = ty0t.shape
    dev = ty0t.device
    a = torch.div(torch.clamp_min(ty0t, 0), rpt, rounding_mode="floor")
    b = torch.div(torch.clamp_max(ty1t, n_ty - 1), rpt, rounding_mode="floor")
    c = torch.arange(_N_COARSE, dtype=torch.int32, device=dev)[None, :, None]
    ov = (a[:, None, :] <= c) & (b[:, None, :] >= c)  # [B, 8, N]
    if keep is not None:
        ov &= keep
    ar = torch.arange(N, dtype=torch.int32, device=dev)[None, None, :]
    order = torch.where(ov, ar, torch.full((), N, dtype=torch.int32, device=dev))
    gl = torch.sort(order, dim=-1).values
    if cap_g > N:
        pad = torch.full((B, _N_COARSE, cap_g - N), N, dtype=torch.int32, device=dev)
        gl = torch.cat([gl, pad], dim=-1)
    return gl.contiguous(), torch.sum(ov, dim=-1, dtype=torch.int32)[..., None]


class _ScatterPlan(NamedTuple):
    """The static decisions of `_bin_splats_scatter` (render_pallas.py:914-950)."""

    rpg: int  # tile rows a row group, and a coarse band, holds
    cap_s: int  # the list length the budget allows a tile
    two_level: bool  # band lists (and band column ranges) are read
    corner_x: bool  # the band-level corner cull applies


def _scatter_plan(n_tx, n_ty, cap, N, pad_slots, corner) -> Optional[_ScatterPlan]:
    """JAX's rules for the scatter binning, or None where it bins densely
    (the budget leaves a tile fewer than max(16, pad_slots) slots). Reads
    SCATTER_BUDGET through the module at call time."""
    rpg = max(1, _cdiv(n_ty, _N_COARSE))
    # the Mosaic block rule that also decides rpg: tiles per group % 8 == 0
    while rpg < n_ty and _cdiv(n_ty, rpg) > 1 and (rpg * n_tx) % 8 != 0:
        rpg += 1
    rpg = min(rpg, n_ty)
    cap_s = min(cap, SCATTER_BUDGET // (rpg * n_tx * 4) - 1)  # column 0 held the count
    if cap_s < max(16, pad_slots):
        return None
    two_level = _cdiv(n_ty, rpg) > 1 and _cdiv(N, 128) * 128 <= 8192
    return _ScatterPlan(rpg, cap_s, two_level, corner is not None and two_level)


@torch.no_grad()
def scatter_args(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, pad_slots=SCATTER_PAD,
                 corner=None) -> Optional[dict]:
    """The XLA-side half of `_bin_splats_scatter` in plain PyTorch: the
    keyword arguments of bin_splats_scatter_plain (tile bounds, band lists,
    band column ranges, the overflow fallback's boxes and corner
    parameters), or None where the rules bin densely. K5 on the card
    computes all of it from the boxes itself."""
    plan = _scatter_plan(n_tx, n_ty, cap, x0.shape[1], pad_slots, corner)
    if plan is None:
        return None
    return _scatter_args(plan, x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, corner)


@torch.no_grad()
def _scatter_args(plan: _ScatterPlan, x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap,
                  corner) -> dict:
    """scatter_args under a plan already made."""
    N = x0.shape[1]
    div = functools.partial(torch.div, rounding_mode="floor")
    rng = torch.stack([div(x0, tile_w), div(x1, tile_w), div(y0, tile_h), div(y1, tile_h)], 1)
    rng = rng.to(torch.int32).contiguous()
    gl = gcnt = cxr = fallback = None
    if plan.two_level:
        keep = None
        if plan.corner_x:
            txl, txh = _corner_band_xranges(corner, x0, x1, y0, y1, plan.rpg * tile_h, tile_w)
            keep = txl <= txh  # a splat culled from the whole band is not walked
            cxr = torch.stack([txl, txh], dim=2).contiguous()  # [B, 8, 2, N]
            if plan.cap_s < cap:
                fallback = (x0, x1, y0, y1, corner)
        gl, gcnt = _band_lists(rng[:, 2], rng[:, 3], n_ty, plan.rpg, _cdiv(N, 128) * 128, keep)
    return dict(rng=rng, gl=gl, gcnt=gcnt, cxr=cxr, n_tx=n_tx, n_ty=n_ty, tile_h=tile_h,
                tile_w=tile_w, rpg=plan.rpg, cap=cap, cap_s=plan.cap_s, fallback=fallback)


@torch.no_grad()
def bin_splats_scatter_plain(rng, gl, gcnt, cxr, n_tx, n_ty, tile_h, tile_w, rpg, cap, cap_s,
                             fallback=None):
    """Plain version of K5, from scatter_args' arguments: -> (idx [B, T,
    cap] int32 padded with N, cnt [B, T], tmax 0-d int32). Tile (row ty,
    column tx) keeps splat s iff rng's rows cover ty and tx lies in s's
    column range: the band's
    [txl, txh] (cxr, band ty // rpg) or the box's; lists ascending, the
    first cap kept, cnt = min(count, cap), tmax the largest true count over
    the batch. With `fallback` (the band cull under cap_s < cap) and
    tmax > cap_s, the lists are bin_splats_dense's with the per-tile corner
    test (render_pallas.py:1012-1035). The band lists gl/gcnt are not read:
    a splat missing from its band's list fails the row or the column test."""
    B, _, N = rng.shape
    dev = rng.device
    T = n_tx * n_ty
    t = torch.arange(T, dtype=torch.int32, device=dev)
    tx, ty = (t % n_tx)[None, :, None], (t // n_tx)[None, :, None]
    if cxr is None:
        lo, hi = rng[:, 0, None, :], rng[:, 1, None, :]
    else:
        band = ((t // n_tx) // rpg).long()
        lo, hi = cxr[:, band, 0, :], cxr[:, band, 1, :]  # [B, T, N]
    ov = (rng[:, 2, None, :] <= ty) & (rng[:, 3, None, :] >= ty) & (lo <= tx) & (hi >= tx)
    ar = torch.arange(N, dtype=torch.int32, device=dev)[None, None, :]
    order = torch.where(ov, ar, torch.full((), N, dtype=torch.int32, device=dev))
    idx = torch.sort(order, dim=-1).values[..., :cap].contiguous()
    true = torch.sum(ov, dim=-1, dtype=torch.int32)
    tmax = torch.amax(true)
    if fallback is not None and cap_s < cap and int(tmax) > cap_s:
        x0, x1, y0, y1, corner = fallback
        idx, cnt = bin_splats_dense(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, corner)
        return idx, cnt, tmax
    return idx, torch.clamp_max(true, cap), tmax


_BAND_CHUNK = 256  # splats a block of K5's band stage walks (csrc/scatter.cu kChunk)


def _pack_range(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """K5's packed tile range: [lo, hi] within [0, n) as lo | (hi + 1) << 16,
    each clamped to [0, n] (csrc/scatter.cu pack_range), so that for
    0 <= v < n, lo <= v <= hi iff (lo' <= v < hi')."""
    return torch.clamp(lo, 0, n) | ((torch.clamp(hi, -1, n - 1) + 1) << 16)


@torch.no_grad()
def scatter_band_entries_plain(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, rpg, corner=None):
    """Plain version of K5's band stage: pixel boxes [B, N] int32 -> (ent
    [B, nb, nc, 256, 4] int32, cnt [B, nb, nc] int32) for nb = ceil(n_ty /
    rpg) bands and nc = max(1, ceil(N / 256)) chunks of 256 splats. Chunk c
    of band k holds from ent[b, k, c, 0], ascending, the entries of its
    splats whose tile rows reach the band (`_band_lists`' row test without
    its cull filter), cnt of them, and zeros after: (s, its tile rows within
    the band, the band's tile columns, the box's tile columns), each range
    packed by _pack_range. The band's columns are `_corner_band_xranges`'
    under `corner`, else the box's."""
    B, N = x0.shape
    dev = x0.device
    nb, nc = _cdiv(n_ty, rpg), max(1, _cdiv(N, _BAND_CHUNK))
    div = functools.partial(torch.div, rounding_mode="floor")
    tx0, tx1, ty0, ty1 = div(x0, tile_w), div(x1, tile_w), div(y0, tile_h), div(y1, tile_h)
    k = torch.arange(nb, dtype=torch.int32, device=dev)[None, :, None]
    a = div(torch.clamp_min(ty0, 0), rpg)[:, None, :]
    z = div(torch.clamp_max(ty1, n_ty - 1), rpg)[:, None, :]
    in_row = (a <= k) & (z >= k)  # [B, nb, N]
    if corner is None:
        txl, txh = tx0[:, None, :], tx1[:, None, :]
    else:
        txl, txh = _corner_band_xranges(corner, x0, x1, y0, y1, rpg * tile_h, tile_w)
        txl, txh = txl[:, :nb], txh[:, :nb]
    shape = (B, nb, N)
    ent = torch.stack([
        torch.arange(N, dtype=torch.int32, device=dev).expand(shape),
        _pack_range(ty0[:, None, :] - k * rpg, ty1[:, None, :] - k * rpg, rpg),
        _pack_range(txl, txh, n_tx).expand(shape),
        _pack_range(tx0, tx1, n_tx)[:, None, :].expand(shape),
    ], -1) * in_row[..., None]
    pad = nc * _BAND_CHUNK - N
    ent = torch.cat([ent, ent.new_zeros((B, nb, pad, 4))], 2).reshape(B, nb, nc, _BAND_CHUNK, 4)
    keep = torch.cat([in_row, in_row.new_zeros((B, nb, pad))], 2).reshape(B, nb, nc, _BAND_CHUNK)
    # each chunk's kept entries first, in ascending order
    order = torch.sort((~keep).to(torch.int8), dim=-1, stable=True).indices
    ent = torch.gather(ent, 3, order[..., None].expand(B, nb, nc, _BAND_CHUNK, 4))
    return ent.contiguous(), torch.sum(keep, dim=-1, dtype=torch.int32)


def _k5_rows(rows, dtype, B: int, N: int, dev, what: str):
    """K5's [B, N] input rows as ctypes arrays of pointers and batch strides
    (rows of K4's tables are read in place: only the last stride must be 1)."""
    for r in rows:
        if r.dtype != dtype:
            raise TypeError(f"{what}: rows of dtype {r.dtype}, expected {dtype}")
        if r.device != dev or tuple(r.shape) != (B, N):
            raise ValueError(f"{what}: expected [{B}, {N}] rows on {dev}, got "
                             f"{tuple(r.shape)} on {r.device}")
        if N > 1 and r.stride(1) != 1:
            raise ValueError(f"{what}: each row's last stride must be 1")
    return ((ctypes.c_void_p * len(rows))(*(r.data_ptr() for r in rows)),
            (ctypes.c_longlong * len(rows))(*(r.stride(0) for r in rows)))


def _band_launch(k, box, cpar, log2eps, B, N, n_tx, n_ty, tile_h, tile_w, rpg, dev, stream):
    """One launch of K5's band stage: (ent, ent_cnt, tmax zeroed)."""
    ent = torch.empty((B, _cdiv(n_ty, rpg), max(1, _cdiv(N, _BAND_CHUNK)), _BAND_CHUNK, 4),
                      dtype=torch.int32, device=dev)
    ent_cnt = torch.empty(ent.shape[:3], dtype=torch.int32, device=dev)
    tmax = torch.empty((), dtype=torch.int32, device=dev)
    rc = k.scatter.ggs_scatter_bands(*box, *(cpar or (None, None)), log2eps, ent.data_ptr(),
                                     ent_cnt.data_ptr(), tmax.data_ptr(), B, N, n_tx, n_ty,
                                     tile_h, tile_w, rpg, stream)
    k.check(rc, "bin_splats_scatter (band stage)")
    profiling.count("K5-band")
    return ent, ent_cnt, tmax


def scatter_band_entries(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, rpg, corner=None):
    """K5's band stage alone: as scatter_band_entries_plain, where the
    kernel leaves the slots after each chunk's cnt entries unwritten."""
    if x0.device.type == "cpu":
        return scatter_band_entries_plain(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, rpg, corner)
    B, N = x0.shape
    dev = x0.device
    box = _k5_rows((x0, x1, y0, y1), torch.int32, B, N, dev, "box")
    cpar = None if corner is None else _k5_rows(corner[:6], torch.float32, B, N, dev, "corner")
    k = build()
    with torch.cuda.device(dev):
        ent, ent_cnt, _ = _band_launch(
            k, box, cpar, 0.0 if corner is None else float(corner[6]), B, N, n_tx, n_ty, tile_h,
            tile_w, rpg, dev, torch.cuda.current_stream(dev).cuda_stream)
    return ent, ent_cnt


def bin_splats_scatter(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, pad_slots=SCATTER_PAD,
                       corner=None):
    """K5: the scatter binning of one pass, from the pixel boxes [B, N]
    int32 (and `corner`, the fast tier's `_corner_params`) to (idx [B, T,
    cap] int32 padded with N, cnt [B, T], tmax 0-d int32, the largest true
    count), equal to scatter_args then bin_splats_scatter_plain, which a
    CPU tensor takes.

    Replaces ggs_tpu/ops/render_pallas.py:_scatter_bin_kernel (pallas_call
    in _bin_splats_scatter) and the band lists and band column ranges the
    JAX package computes in XLA around it. On the card, two or three
    launches (csrc/scatter.cu): with bands, the band stage (a block per
    (candidate, band, 256 splats) writes the row lists' entries with their
    tile rows and the band's tile columns, computing `_corner_band_xranges`
    under the cull); the tile stage (a block per tile row and up to 8
    columns stages the band's entries in shared memory, a warp per tile
    appends its kept ones in order by a ballot, no atomic on a slot, and
    pads with N); and, with the band cull under cap_s < cap, the overflow
    fallback, which reads tmax on the card and returns at once unless it
    exceeds cap_s, else rebuilds the lists from the row lists by the box
    and the per-tile corner test. Without bands (one row group, or above
    8192 splats) the tile stage walks every splat's box, after a zeroing of
    tmax. Counts its calls (one tile stage each) as "K5", its band stages
    as "K5-band" and its calls that also launched the fallback as
    "K5-fallback" (whether it rebuilt the lists is known only on the card)
    in profiling.COUNTS. Bound by bytes: the padded lists written."""
    plan = _scatter_plan(n_tx, n_ty, cap, x0.shape[1], pad_slots, corner)
    if plan is None:
        raise ValueError("the scatter rules bin this shape densely (bin_splats_dense)")
    return _scatter(plan, x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, corner)


def _scatter(plan: _ScatterPlan, x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, corner):
    """bin_splats_scatter under a plan already made."""
    if x0.device.type == "cpu":
        return bin_splats_scatter_plain(
            **_scatter_args(plan, x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, corner))
    B, N = x0.shape
    dev = x0.device
    box = _k5_rows((x0, x1, y0, y1), torch.int32, B, N, dev, "box")
    cpar = _k5_rows(corner[:6], torch.float32, B, N, dev, "corner") if plan.corner_x else None
    log2eps = float(corner[6]) if plan.corner_x else 0.0
    fallback = plan.corner_x and plan.cap_s < cap
    T = n_tx * n_ty
    idx = torch.empty((B, T, cap), dtype=torch.int32, device=dev)
    cnt = torch.empty((B, T), dtype=torch.int32, device=dev)
    k = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.two_level:
            ent, ent_cnt, tmax = _band_launch(k, box, cpar, log2eps, B, N, n_tx, n_ty, tile_h,
                                              tile_w, plan.rpg, dev, stream)
            bands = (ent.data_ptr(), ent_cnt.data_ptr())
        else:
            tmax = torch.zeros((), dtype=torch.int32, device=dev)
            bands = (None, None)
        rc = k.scatter.ggs_scatter_tiles(
            *box, *(cpar or (None, None)), log2eps, *bands, idx.data_ptr(), cnt.data_ptr(),
            tmax.data_ptr(), B, N, n_tx, n_ty, tile_h, tile_w, plan.rpg, cap, plan.cap_s,
            int(fallback), stream,
        )
        k.check(rc, "bin_splats_scatter")
    profiling.count("K5")
    profiling.count("K5-fallback", fallback)
    return idx, cnt, tmax


def _bin_plan(B, n_tx, n_ty, cap, N, pad_slots, corner, device) -> Optional[_ScatterPlan]:
    """bin_splats' route: K5's plan, or None for the dense binning. Under
    the corner cull the route decides the lists, so it is JAX's
    (`_bin_splats_xy`): the scatter binning from SCATTER_TILES tiles where
    its rules give a plan, else dense. Without the cull both routes give the
    same integers, and on the card K5 takes every tile count with a plan,
    for batches its launch takes (csrc/scatter.cu geometry: B <= 65535;
    below SCATTER_TILES tiles its B*T < 2**31 then holds too): on an H100 it
    beats the dense sort at every shape of the benchmark, from B=1 on 96
    tiles (0.025 against 0.066 device ms) to B=1024 on 128 tiles (1.65
    against 65.4, a 5,000-splat pass). The CPU keeps bin_splats_dense, the
    plain version."""
    plan = _scatter_plan(n_tx, n_ty, cap, N, pad_slots, corner)
    if plan is None or n_tx * n_ty >= SCATTER_TILES:
        return plan
    if corner is None and B <= 65535 and torch.device(device).type != "cpu":
        return plan
    return None


def bin_route(B, n_tx, n_ty, cap, N, pad_slots, corner, device) -> str:
    """The route bin_splats takes (_bin_plan): "k5" or "dense"."""
    return "dense" if _bin_plan(B, n_tx, n_ty, cap, N, pad_slots, corner, device) is None else "k5"


def bin_splats(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, corner=None,
               pad_slots=SCATTER_PAD):
    """Boxes [B, N] -> (idx [B, T, cap], cnt [B, T]) (`_bin_splats_xy`,
    render_pallas.py:613) by the route it plans once (`bin_route`): K5 (its
    plain version on the CPU) or bin_splats_dense. Counts its calls by
    route as "bin.k5" and "bin.dense" in profiling.COUNTS. Under the corner
    cull K5's lists, while two-level, keep each band's column ranges (weaker
    than the per-tile test, so supersets of the dense corner lists), and
    where a budget cap_s < cap overflows, the per-tile test's."""
    with profiling.span("render.bin"):
        B, N = x0.shape
        plan = _bin_plan(B, n_tx, n_ty, cap, N, pad_slots, corner, x0.device)
        if plan is None:
            profiling.count("bin.dense")
            return bin_splats_dense(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap,
                                    corner=corner)
        profiling.count("bin.k5")
        idx, cnt, _ = _scatter(plan, x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, corner)
        return idx, cnt


@torch.no_grad()
def max_bin_count(g9, H: int, W: int, k_sigma: float = 3.0, tile_h: int = 16,
                  tile_w: int = 128) -> torch.Tensor:
    """Diagnostic (render_pallas.py:1606): the largest per-tile splat count
    of these genomes, the least lossless bin_capacity (0-d int32)."""
    g9 = _genomes(g9)
    p = codec.preprocess(g9, H, W, k_sigma)
    _, cnt = bin_splats(p.x0, p.x1, p.y0, p.y1, _cdiv(W, tile_w), _cdiv(H, tile_h), tile_h,
                        tile_w, g9.shape[1])
    return torch.amax(cnt)


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


def _walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, mode="exact", init=None):
    """The walk in plain PyTorch over the same lists: slot k of every
    (candidate, tile) list at once, blended where k < cnt, from the
    background or from the init canvas [B, 3, Hp, Wp]. Returns the clamped
    (r, g, b) planes, each [B, T, tile_h, tile_w] f32.

    mode "exact": f = exp(sum left to right) * a over the closed box,
    C = (1 - f) C + f c. "fast" (the turbo table): f = exp2(nsxx qx^2 +
    (nsxy qx qy + (nsyy qy^2 + log2a))) over the open thresholds,
    C = C + f (c - C). "bf16": the exact walk with qx, qy cast to bf16
    after the f32 subtraction and every later operation in bf16, on a bf16
    canvas, the init rounded to bf16 (render_pallas.py:1123-1165)."""
    B, T, _ = idx.shape
    dev = feats.device
    t = torch.arange(T, device=dev)
    xf = ((t % n_tx) * tile_w)[:, None, None] + torch.arange(tile_w, device=dev)[None, None, :]
    yf = ((t // n_tx) * tile_h)[:, None, None] + torch.arange(tile_h, device=dev)[None, :, None]
    xf = xf.to(torch.float32)[None]  # [1, T, 1, tw]
    yf = yf.to(torch.float32)[None]  # [1, T, th, 1]
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    if init is None:
        canvas = [
            torch.full((B, T, tile_h, tile_w), float(c), dtype=dt, device=dev) for c in background
        ]
    else:
        it = _tiles_of(init, n_tx, tile_h, tile_w)  # [B, 3, T, th, tw]
        canvas = [it[:, i].to(dt) for i in range(3)]
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


def _untile(tiles: torch.Tensor, n_tx: int) -> torch.Tensor:
    """[..., T, tile_h, tile_w] -> [..., Hp, Wp], the inverse of _tiles_of."""
    *lead, T, tile_h, tile_w = tiles.shape
    n_ty = T // n_tx
    x = tiles.reshape(*lead, n_ty, n_tx, tile_h, tile_w).transpose(-3, -2)
    return x.reshape(*lead, n_ty * tile_h, n_tx * tile_w)


def render_tiles_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, mode="exact",
                       init=None):
    """Plain version of K2 (mode "exact") and K3's canvas (mode "fast"):
    the clamped canvas [B, 3, Hp, Wp]."""
    planes = _walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, mode, init)
    return _untile(torch.stack(planes, 1), n_tx)


def fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background,
                        mode="exact", init=None):
    """Plain version of K1 (mode "exact"), K3's fitness ("fast") and K1-bf16
    ("bf16"): partials [B, T] = sum_px w * sum_ch (C - target)^2, in f32."""
    cr, cg, cb = _walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, mode, init)
    tt = _tiles_of(target_p, n_tx, tile_h, tile_w)  # [3, T, th, tw]
    wt = _tiles_of(w_p, n_tx, tile_h, tile_w)  # [T, th, tw]
    dr = cr - tt[0]
    dg = cg - tt[1]
    db = cb - tt[2]
    return torch.sum((dr * dr + dg * dg + db * db) * wt, dim=(-2, -1))


def walk_path_counts(cnt, idx, feats, n_tx, tile_h, mode="exact") -> dict:
    """How the forward walks (csrc/walk.cu, 128-column list tiles) take
    these lists, counted per visit: a (list entry k < cnt, sub-tile of 4
    rows, warp of 32 columns) triple. "dropped": the splat's rows miss the
    sub-tile's, so it is not staged; "skipped": its columns miss the warp's;
    "covered": its box holds the sub-tile's rows and the warp's columns (no
    select); "rows_only": the rows but not every column (a select on the
    column); "partial": not every row (the select per pixel). The tests are
    the kernel's, on the table's boxes (under "fast" its open thresholds).
    Returns {path: int} and "visits", their sum. Plain PyTorch on the lists'
    device, for measuring the walk's inputs; no walk calls it."""
    B, T, L = idx.shape
    S, rows, warp, tile_w = tile_h // 4, 4, 32, 128
    dev = idx.device
    box = torch.gather(feats[:, _F_X0:_F_Y1 + 1], 2,
                       idx.long().reshape(B, 1, T * L).expand(B, 4, T * L))
    x0, x1, y0, y1 = box.reshape(B, 4, T, L).unbind(1)
    live = torch.arange(L, device=dev)[None, None, :] < cnt[:, :, None]
    t = torch.arange(T, device=dev)
    tx0 = ((t % n_tx) * tile_w).to(torch.float32)[None, :, None]
    ty0 = ((t // n_tx) * tile_h).to(torch.float32)[None, :, None]
    fast = mode == "fast"
    kept = rows_in = hit = cols_in = torch.zeros((B, T, L), dtype=torch.int64, device=dev)
    for s in range(S):  # staged (kept) and, of those, rows held
        yb = ty0 + float(rows * s)
        ye = yb + float(rows - 1)
        k = (y0 < ye) & (y1 > yb) if fast else ~((y1 < yb) | (y0 > ye))
        r = (y0 < yb) & (y1 > ye) if fast else (y0 <= yb) & (y1 >= ye)
        kept, rows_in = kept + k, rows_in + (k & r)
    for w in range(tile_w // warp):  # walked by the warp and, of those, columns held
        wx0 = tx0 + float(warp * w)
        wx1 = wx0 + float(warp - 1)
        h = (x0 < wx1) & (x1 > wx0) if fast else ~((x1 < wx0) | (x0 > wx1))
        c = (x0 < wx0) & (x1 > wx1) if fast else (x0 <= wx0) & (x1 >= wx1)
        hit, cols_in = hit + h, cols_in + (h & c)
    warps = tile_w // warp
    per = {
        "dropped": (S - kept) * warps,
        "skipped": kept * (warps - hit),
        "covered": rows_in * cols_in,
        "rows_only": rows_in * (hit - cols_in),
        "partial": (kept - rows_in) * hit,
    }
    out = {k: int((v * live).sum()) for k, v in per.items()}
    out["visits"] = sum(out.values())
    return out


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


def _check_init(init, B, Hp, Wp, dev):
    if init is not None:
        _require(init, "init", torch.float32, (B, 3, Hp, Wp), dev)


def _render_launch(mode, what, cnt, idx, feats, n_tx, tile_h, tile_w, background, init):
    """One launch of walk.cu's canvas epilogue in blend mode `mode`."""
    B, T, L, dev = _check_lists(cnt, idx, feats, n_tx, tile_h, tile_w)
    Hp, Wp = (T // n_tx) * tile_h, n_tx * tile_w
    _check_init(init, B, Hp, Wp, dev)
    out = torch.empty((B, 3, Hp, Wp), dtype=torch.float32, device=dev)
    k = build()
    with torch.cuda.device(dev):
        rc = k.lib.ggs_walk_render(
            _MODES[mode], cnt.data_ptr(), idx.data_ptr(), feats.data_ptr(),
            None if init is None else init.data_ptr(), out.data_ptr(),
            B, T, L, feats.shape[2], n_tx, tile_h, tile_w, Hp, Wp,
            *(float(c) for c in background), torch.cuda.current_stream(dev).cuda_stream,
        )
    k.check(rc, what)
    return out


# Per (device, stream): walk.cu's per-tile ticket counters for the fitness
# epilogue's sum over sub-tiles, and in slot 0 walk_grad.cu's item queue,
# zeroed once where allocated; every launch leaves them 0 again, so a launch
# adds no zeroing launch. Launches on one stream run in turn, so the two
# kernels share the slot. A buffer outgrown is kept: a captured CUDA graph
# may still launch on it.
_TICKETS: dict = {}
_RETIRED: list = []


def _tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return buf


def _fitness_launch(mode, what, cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background,
                    init):
    """One launch of walk.cu's fitness epilogue in blend mode `mode`: a block
    per 4-row sub-tile, the sub-tiles' partials in `sub` (scratch), summed
    per tile in order on the card."""
    B, T, L, dev = _check_lists(cnt, idx, feats, n_tx, tile_h, tile_w)
    Hp, Wp = (T // n_tx) * tile_h, n_tx * tile_w
    _require(target_p, "target_p", torch.float32, (3, Hp, Wp), dev)
    _require(w_p, "w_p", torch.float32, (Hp, Wp), dev)
    _check_init(init, B, Hp, Wp, dev)
    out = torch.empty((B, T), dtype=torch.float32, device=dev)
    k = build()
    sub = torch.empty((B, T, tile_h // k.lib.ggs_walk_sub_rows()), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = k.lib.ggs_walk_fitness(
            _MODES[mode], cnt.data_ptr(), idx.data_ptr(), feats.data_ptr(),
            None if init is None else init.data_ptr(), target_p.data_ptr(), w_p.data_ptr(),
            out.data_ptr(), sub.data_ptr(), _tickets(dev, stream, B * T).data_ptr(),
            B, T, L, feats.shape[2], n_tx, tile_h, tile_w, Hp, Wp,
            *(float(c) for c in background), stream,
        )
    k.check(rc, what)
    return out


def render_tiles(cnt, idx, feats, n_tx, tile_h, tile_w, background, init=None):
    """K2: lists + table -> clamped canvas [B, 3, Hp, Wp], from the
    background or from `init` [B, 3, Hp, Wp] (a chained pass).

    Replaces ggs_tpu/ops/render_pallas.py:_render_tile_kernel (pallas_call
    in _render_padded). Bound by the walk's f32 arithmetic, about 30
    operations and one exp per (splat, pixel) pair; a 128-thread block per
    4x128 sub-tile (tile_w 128, tile_h a multiple of 4) keeps its canvas in
    registers for the whole walk and writes it once (csrc/walk.cu)."""
    if feats.device.type == "cpu":
        return render_tiles_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, init=init)
    out = _render_launch("exact", "render_tiles", cnt, idx, feats, n_tx, tile_h, tile_w, background,
                         init)
    profiling.count("K2")
    profiling.count("K2-init", init is not None)
    return out


def render_tiles_fast(cnt, idx, feats, n_tx, tile_h, tile_w, background, init=None):
    """K3, canvas epilogue: lists + the fast table (_splat_feats_turbo) ->
    clamped canvas [B, 3, Hp, Wp], from the background or `init`.

    Replaces _render_tile_kernel with turbo=True (the walk
    _composite_tile.blend_one_turbo, render_pallas.py:1077). Bound as K2,
    with exp2f for expf and no alpha multiply (csrc/walk.cu, mode 1)."""
    if feats.device.type == "cpu":
        return render_tiles_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, mode="fast",
                                  init=init)
    out = _render_launch("fast", "render_tiles_fast", cnt, idx, feats, n_tx, tile_h, tile_w,
                         background, init)
    profiling.count("K3-canvas")
    profiling.count("K3-canvas-init", init is not None)
    return out


def fitness_tiles(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background, init=None):
    """K1: lists + table + padded target [3, Hp, Wp] and weights [Hp, Wp]
    (0 on the padding) -> partials [B, T] of sum_px w * sum_ch (C - target)^2,
    the walk starting from the background or from `init` [B, 3, Hp, Wp].

    Replaces ggs_tpu/ops/render_pallas.py:_fitness_tile_kernel (pallas_call
    in _fitness_partials). Bound by the walk's f32 arithmetic; the canvas
    never leaves registers, and the per-tile sum is fixed-order (rows, warps,
    then the tile's 4-row sub-tiles in order, in the same launch; no atomics
    on values), so the partials are the same bits on every run
    (csrc/walk.cu)."""
    if feats.device.type == "cpu":
        return fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background,
                                   init=init)
    out = _fitness_launch("exact", "fitness_tiles", cnt, idx, feats, target_p, w_p, n_tx, tile_h,
                          tile_w, background, init)
    profiling.count("K1")
    profiling.count("K1-init", init is not None)
    return out


def fitness_tiles_fast(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background,
                       init=None):
    """K3, fitness epilogue: as K1 over the fast table (K4's ff or
    _splat_feats_turbo). Replaces _fitness_tile_kernel with turbo=True
    (render_pallas.py:1460); csrc/walk.cu, mode 1."""
    if feats.device.type == "cpu":
        return fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w,
                                   background, mode="fast", init=init)
    out = _fitness_launch("fast", "fitness_tiles_fast", cnt, idx, feats, target_p, w_p, n_tx,
                          tile_h, tile_w, background, init)
    profiling.count("K3")
    profiling.count("K3-init", init is not None)
    return out


def fitness_tiles_bf16(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background,
                       init=None):
    """K1-bf16: as K1 over the exact table with the walk and canvas in bf16
    (an init rounded to bf16 where it enters), each operation rounded to
    bf16 as torch rounds it, the loss epilogue in f32. Replaces
    _fitness_tile_kernel with compute_dtype=bfloat16 (render_pallas.py:1367);
    csrc/walk.cu, mode 2: a thread's four rows in two bf16x2 registers a
    channel, each bf16 operation one packed instruction."""
    if feats.device.type == "cpu":
        return fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w,
                                   background, mode="bf16", init=init)
    out = _fitness_launch("bf16", "fitness_tiles_bf16", cnt, idx, feats, target_p, w_p, n_tx,
                          tile_h, tile_w, background, init)
    profiling.count("K1-bf16")
    profiling.count("K1-bf16-init", init is not None)
    return out


def prep_fast(g9: torch.Tensor, H: int, W: int, k_sigma: float, cull_eps=None):
    """K4: renderer genomes [B, N, 9] -> (ff [B, 13, N+1], fi [B, 4, N] int32),
    as prep_fast_plain.

    Replaces ggs_tpu/ops/render_pallas.py:_prep_turbo_kernel (pallas_call in
    _prep_turbo_pallas). One thread per (candidate, splat) reads the genome
    in place (no transpose copy); a few dozen operations against 36 bytes in
    and 68 out a splat, so bytes and the launch bound it (csrc/walk.cu)."""
    with profiling.span("render.feats"):
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
                float(k_sigma), eps, math.log(eps),
                torch.cuda.current_stream(g9.device).cuda_stream,
            )
        k.check(rc, "prep_fast")
        profiling.count("K4")
        return ff, fi


# -------------------------------------------------------- entry points


def _genomes(g9: torch.Tensor) -> torch.Tensor:
    """Renderer genomes [B, N, >= 9] (or [N, >= 9]) -> [B, N, 9] f32."""
    if g9.dim() == 2:
        g9 = g9[None]
    if g9.shape[2] < codec.GENE_DIM:
        raise ValueError(f"expected >= 9 genome cols, got {g9.shape[2]}")
    return g9[..., : codec.GENE_DIM].to(torch.float32)


def shift_rows(p: codec.SplatScreen, y_origin: int) -> codec.SplatScreen:
    """Screen-space splats in the coordinates of the row slab that starts at
    global row y_origin: cy - y_origin in f32 (exact for an integer origin
    while cy >= y_origin), y0 and y1 shifted as integers. Splats wholly above
    or below the slab get boxes outside [0, slab rows) and bin to no tile.
    Differentiable: d(cy - y0)/d(cy) = 1."""
    y_origin = int(y_origin)
    if y_origin == 0:
        return p
    return p._replace(cy=p.cy - float(y_origin), y0=p.y0 - y_origin, y1=p.y1 - y_origin)


def slab_tile_h(rows: int) -> Optional[int]:
    """The walks' tile height on a row slab: the first of 64, 32, 16 and 8
    that divides its rows (objective.py:361, render_pallas.py:1596), or None."""
    return next((t for t in (64, 32, 16, 8) if rows % t == 0), None)


def _split_screen(p: codec.SplatScreen, lo: int, hi: int) -> codec.SplatScreen:
    return codec.SplatScreen(*(f[:, lo:hi] for f in p))


def _chunk_bounds(N: int) -> list:
    """Pass bounds i*N//n of the n = ceil(N / MAX_SPLATS) passes (at least one)."""
    n = max(1, _cdiv(N, MAX_SPLATS))
    return [i * N // n for i in range(n + 1)]


def _pass_lists(p, n_tx, n_ty, tile_h, tile_w, bin_capacity, t: screen.Tier):
    """One pass's (cnt, idx, feats): its own lists with cap = min(bin_capacity,
    its N), corner-culled under the tier's corner eps, and the table its
    walk reads (`_render_padded`, :84-100)."""
    N = p.cx.shape[1]
    cap = N if bin_capacity is None else min(bin_capacity, N)
    corner = None if t.corner_eps is None else _corner_params(p, t.corner_eps)
    idx, cnt = bin_splats(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, tile_h, tile_w, cap, corner)
    feats = _splat_feats_turbo(p) if t.mode == "fast" else _splat_feats_fast(p)
    return cnt, idx, feats


def _chunked_passes(p, H, W, tile_h, tile_w, background, bin_capacity, keep_last,
                    t: screen.Tier):
    """Splats in passes of at most MAX_SPLATS (screen.passes), each walked
    from the previous pass's clamped canvas (`_chunked_passes`,
    render_pallas.py:141): "over" composites in painter order, so the chain
    equals one pass while no list is cut. Returns (the canvas before the
    last pass, the last pass's (cnt, idx, feats)) when keep_last (a fitness
    epilogue walks those), else (the canvas, None). The passes walk K3's
    canvas in the fast mode, else K2's (f32 also under "bf16")."""
    n_tx, n_ty = _cdiv(W, tile_w), _cdiv(H, tile_h)
    walk = render_tiles_fast if t.mode == "fast" else render_tiles
    pcs = screen.passes(p)
    canvas = None
    for i, pc in enumerate(pcs):
        lists = _pass_lists(pc, n_tx, n_ty, tile_h, tile_w, bin_capacity, t)
        if keep_last and i == len(pcs) - 1:
            return canvas, lists
        with profiling.span("render.walk"):
            canvas = walk(*lists, n_tx, tile_h, tile_w, background, init=canvas)
    return canvas, None


def _fitness_walk(t: screen.Tier):
    """The fitness epilogue of the tier's mode: K1, K3 or K1-bf16."""
    return {"fast": fitness_tiles_fast, "bf16": fitness_tiles_bf16}.get(t.mode, fitness_tiles)


def _k4_pass(g9, H, W, k_sigma, bin_capacity, tile_h, tile_w, t: screen.Tier):
    """Fast fitness's single-pass route (fitness_pallas, render_pallas.py:
    1345-1355, 1411-1421): renderer genomes [B, N <= MAX_SPLATS, 9] ->
    (cnt, idx, ff), K4's table and eps-tight boxes, binned with the corner
    parameters sliced from K4's rows 0-4 and 8."""
    N = g9.shape[1]
    ff, fi = prep_fast(g9.contiguous(), H, W, k_sigma, t.eps)
    corner = None
    if t.corner_eps is not None:
        corner = tuple(ff[:, r, :N] for r in (0, 1, 2, 3, 4, _F_A)) + (math.log2(t.corner_eps),)
    cap = N if bin_capacity is None else min(bin_capacity, N)
    idx, cnt = bin_splats(fi[:, 0], fi[:, 1], fi[:, 2], fi[:, 3], _cdiv(W, tile_w),
                          _cdiv(H, tile_h), tile_h, tile_w, cap, corner=corner)
    return cnt, idx, ff


def pad_planes(target: torch.Tensor, w_eff: Optional[torch.Tensor], Hp: int, Wp: int):
    """target [H, W, 3] and w_eff [H, W] (None = ones) -> K1's zero-padded
    target [3, Hp, Wp] and weights [Hp, Wp]: padding pixels weigh 0."""
    with profiling.span("render.screen"):
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
    corner_cull); "bf16" renders the exact walk over the reference box.
    Above MAX_SPLATS splats the passes chain through the init canvas."""
    squeeze = g9.dim() == 2
    t = screen.tier(precision, cull_eps, corner_cull)
    p = screen.screen(_genomes(g9), H, W, k_sigma, t)
    out, _ = _chunked_passes(p, H, W, tile_h, tile_w, tuple(float(c) for c in background),
                             bin_capacity, False, t)
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
    (fitness_pallas). Candidate canvases never reach device memory in one
    pass. The last (or only) pass walks K1 for the exact tiers, K3 for
    "fast", K1-bf16 for "bf16", from the canvas of the passes before it."""
    t = screen.tier(precision, cull_eps, corner_cull)
    g9 = _genomes(g9)
    N = g9.shape[1]
    n_tx, n_ty = _cdiv(W, tile_w), _cdiv(H, tile_h)
    bg = tuple(float(c) for c in background)
    w_eff, denom = fitness_mod.weff_denom(weight_mask, boost_only, boost_beta, H, W)
    target_p, w_p = pad_planes(target, w_eff, n_ty * tile_h, n_tx * tile_w)
    if t.mode == "fast" and N <= MAX_SPLATS:
        lists = _k4_pass(g9, H, W, k_sigma, bin_capacity, tile_h, tile_w, t)
        init = None
    else:
        p = screen.screen(g9, H, W, k_sigma, t)
        init, lists = _chunked_passes(p, H, W, tile_h, tile_w, bg, bin_capacity, True, t)
    with profiling.span("render.walk"):
        partials = _fitness_walk(t)(*lists, target_p, w_p, n_tx, tile_h, tile_w, bg, init=init)
        return torch.sum(partials, dim=1) / denom  # a 0-d CPU denom is a scalar: no sync


def fitness_partial(
    g9: torch.Tensor,
    target_slab: torch.Tensor,
    w_slab: Optional[torch.Tensor],
    H: int,
    W: int,
    y_origin: int,
    k_sigma: float = 3.0,
    background: Sequence[float] = (1.0, 1.0, 1.0),
    bin_capacity: Optional[int] = None,
    tile_h: int = 64,
    tile_w: int = 128,
    precision: str = "highest",
    cull_eps: Optional[float] = None,
    corner_cull: bool = False,
) -> torch.Tensor:
    """Row-slab partial of the fused fitness (fitness_pallas_partial,
    render_pallas.py:1491): renderer genomes [B, N, 9] -> [B] sums of
    w * sum_ch (C - target)^2 over the slab's rows [y_origin, y_origin + Hs),
    Hs = target_slab.shape[0]; w_slab [Hs, W] (None = ones) holds the
    effective weights. The splats are preprocessed against the whole (H, W)
    canvas and shifted into the slab (shift_rows) before the tier's boxes,
    the corner cull and the table are taken, so the walks (K1, K3, K1-bf16,
    and K2/K3's canvas for the passes before the last) run the full canvas's
    arithmetic on the slab's tiles. The binning route is `bin_route`'s for
    the slab's tile count (under the corner cull dense below SCATTER_TILES
    and K5 from it; without it K5 on the card). The fast tier takes no K4
    here: its table comes from the shifted screen, as in JAX's partial.
    Summed over the slabs of a canvas, the partials give fitness() * denom."""
    t = screen.tier(precision, cull_eps, corner_cull)
    g9 = _genomes(g9)
    Hs = target_slab.shape[0]
    n_tx, n_ty = _cdiv(W, tile_w), _cdiv(Hs, tile_h)
    bg = tuple(float(c) for c in background)
    p = screen.screen(g9, H, W, k_sigma, t, y_origin)
    init, lists = _chunked_passes(p, Hs, W, tile_h, tile_w, bg, bin_capacity, True, t)
    target_p, w_p = pad_planes(target_slab, w_slab, n_ty * tile_h, n_tx * tile_w)
    with profiling.span("render.walk"):
        return torch.sum(_fitness_walk(t)(*lists, target_p, w_p, n_tx, tile_h, tile_w, bg,
                                          init=init), dim=1)


def render_rows(
    g9: torch.Tensor,
    H: int,
    W: int,
    y_origin: int,
    out_rows: int,
    k_sigma: float = 3.0,
    background: Sequence[float] = (1.0, 1.0, 1.0),
    bin_capacity: Optional[int] = None,
    tile_h: int = 8,
    tile_w: int = 128,
    precision: str = "highest",
    cull_eps: Optional[float] = None,
    corner_cull: bool = False,
) -> torch.Tensor:
    """Render out_rows canvas rows from global row y_origin -> [B, out_rows,
    W, 3] (render_rows_pallas, render_pallas.py:1556): the image-producing
    sibling of fitness_partial, with the same shift. The tile is the first of
    64, 32, 16, 8 rows that divides out_rows, else tile_h. Rows past H render
    as background (no box reaches them)."""
    squeeze = g9.dim() == 2
    t = screen.tier(precision, cull_eps, corner_cull)
    p = screen.screen(_genomes(g9), H, W, k_sigma, t, y_origin)
    tile_h = slab_tile_h(out_rows) or tile_h
    out, _ = _chunked_passes(p, out_rows, W, tile_h, tile_w, tuple(float(c) for c in background),
                             bin_capacity, False, t)
    img = out[:, :, :out_rows, :W].permute(0, 2, 3, 1).contiguous()
    return img[0] if squeeze else img
