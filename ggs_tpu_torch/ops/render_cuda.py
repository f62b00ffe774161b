"""Tiled rasterizer: screen-space tables, dense binning, and the two walk
kernels (K1 fused fitness, K2 canvas) with their plain PyTorch versions.

PyTorch/CUDA counterpart of the exact tiers of `ggs_tpu/ops/render_pallas.py`:

* `_splat_feats_fast` (render_pallas.py:189): the pre-folded exact table
  [B, 13, N+1] with a no-op sentinel column N.
* `bin_splats_dense` (render_pallas.py:659): per-tile ascending splat lists
  padded with N, counts capped at `bin_capacity` (plain PyTorch: it is XLA
  code in the JAX package, not a Pallas kernel).
* `fitness_tiles` / `render_tiles`: wrappers of the CUDA kernels in
  `csrc/walk.cu`, each with a launch count and a plain version beside it.
  A CPU tensor takes the plain version; a CUDA tensor launches the kernel
  or raises.
* `render` / `fitness`: the entry points, mirroring `render_pallas` and
  `fitness_pallas` for precision "highest" and "exact-tight", single pass
  (the JAX package chains passes through an init canvas only above 8000
  splats, which this port does not do yet).
"""
from __future__ import annotations

import ctypes
import hashlib
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

EXACT_PRECISIONS = ("highest", "exact-tight")

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
    if precision not in EXACT_PRECISIONS:
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (supported: {EXACT_PRECISIONS})"
        )


# ---------------------------------------------------------------- build


class _Kernels:
    """The loaded kernel libraries and the compiler's report for each."""

    def __init__(self, libs: dict, paths: dict, logs: dict):
        self.lib = lib = libs["walk"]
        self.grad = grad = libs["walk_grad"]
        self.paths = paths
        self.logs = logs
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ggs_walk_render.argtypes = [p, p, p, p] + [i] * 9 + [f, f, f, p]
        lib.ggs_walk_render.restype = i
        lib.ggs_walk_fitness.argtypes = [p, p, p, p, p, p] + [i] * 9 + [f, f, f, p]
        lib.ggs_walk_fitness.restype = i
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


def bin_splats_dense(
    x0, x1, y0, y1, n_tx: int, n_ty: int, tile_h: int, tile_w: int, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABBs [B, N] int32 -> (bin_idx [B, T, cap] int32 ascending, padded
    with N; cnt [B, T] int32 = min(count, cap)). A tile keeps the first cap
    indices of its list when more overlap it."""
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
    ar = torch.arange(N, dtype=torch.int32, device=dev)[None, None, :]
    order = torch.where(ov, ar, torch.full((), N, dtype=torch.int32, device=dev))
    bin_idx = torch.sort(order, dim=-1).values[..., :cap].contiguous()
    cnt = torch.clamp_max(torch.sum(ov, dim=-1, dtype=torch.int32), cap)
    return bin_idx, cnt


# ------------------------------------------------------ plain versions


def _walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background):
    """The walk in plain PyTorch over the same lists: slot k of every
    (candidate, tile) list at once, blended where k < cnt. Returns the
    clamped (r, g, b) planes, each [B, T, tile_h, tile_w]."""
    B, T, _ = idx.shape
    dev = feats.device
    t = torch.arange(T, device=dev)
    xf = ((t % n_tx) * tile_w)[:, None, None] + torch.arange(tile_w, device=dev)[None, None, :]
    yf = ((t // n_tx) * tile_h)[:, None, None] + torch.arange(tile_h, device=dev)[None, :, None]
    xf = xf.to(torch.float32)[None]  # [1, T, 1, tw]
    yf = yf.to(torch.float32)[None]  # [1, T, th, 1]
    canvas = [
        torch.full((B, T, tile_h, tile_w), float(c), dtype=torch.float32, device=dev)
        for c in background
    ]
    kmax = int(cnt.max()) if cnt.numel() else 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for k in range(kmax):
        s = idx[:, :, k].long()  # [B, T]
        pk = torch.gather(feats, 2, s[:, None, :].expand(B, _NFEAT, T))  # [B, 13, T]
        cx, cy, nsxx, nsxy, nsyy, rc, gc, bc, a, x0, x1, y0, y1 = (
            pk[:, r, :, None, None] for r in range(_NFEAT)
        )
        qx = xf - cx
        qy = yf - cy
        quad = nsxx * (qx * qx) + nsxy * (qx * qy) + nsyy * (qy * qy)
        f = torch.exp(quad) * a
        m = (xf >= x0) & (xf <= x1) & (yf >= y0) & (yf <= y1)
        m = m & (k < cnt)[:, :, None, None]
        f = torch.where(m, f, zero)
        one_m_f = 1.0 - f
        canvas = [one_m_f * ch + f * col for ch, col in zip(canvas, (rc, gc, bc))]
    return tuple(torch.clamp(ch, 0.0, 1.0) for ch in canvas)


def _tiles_of(plane: torch.Tensor, n_tx: int, tile_h: int, tile_w: int) -> torch.Tensor:
    """[..., Hp, Wp] -> [..., T, tile_h, tile_w] in tile order t = ty*n_tx + tx."""
    *lead, Hp, Wp = plane.shape
    n_ty = Hp // tile_h
    x = plane.reshape(*lead, n_ty, tile_h, n_tx, tile_w).transpose(-3, -2)
    return x.reshape(*lead, n_ty * n_tx, tile_h, tile_w)


def render_tiles_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, Hp, Wp):
    """Plain version of K2: the clamped canvas [B, 3, Hp, Wp]."""
    B, T, _ = idx.shape
    n_ty = T // n_tx
    planes = torch.stack(_walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background), 1)
    planes = planes.reshape(B, 3, n_ty, n_tx, tile_h, tile_w).transpose(3, 4)
    return planes.reshape(B, 3, Hp, Wp)


def fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background):
    """Plain version of K1: partials [B, T] = sum_px w * sum_ch (C - target)^2."""
    cr, cg, cb = _walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background)
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


def render_tiles(cnt, idx, feats, n_tx, tile_h, tile_w, background):
    """K2: lists + table -> clamped canvas [B, 3, Hp, Wp].

    Replaces ggs_tpu/ops/render_pallas.py:_render_tile_kernel (pallas_call
    in _render_padded). Bound by the walk's f32 arithmetic, about 30
    operations and one exp per (splat, pixel) pair; the canvas stays in
    registers for the whole walk and is written once (csrc/walk.cu)."""
    if feats.device.type == "cpu":
        T = idx.shape[1]
        Hp, Wp = (T // n_tx) * tile_h, n_tx * tile_w
        return render_tiles_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, Hp, Wp)
    B, T, L, dev = _check_lists(cnt, idx, feats, n_tx, tile_h, tile_w)
    Hp, Wp = (T // n_tx) * tile_h, n_tx * tile_w
    out = torch.empty((B, 3, Hp, Wp), dtype=torch.float32, device=dev)
    k = build()
    with torch.cuda.device(dev):
        rc = k.lib.ggs_walk_render(
            cnt.data_ptr(), idx.data_ptr(), feats.data_ptr(), out.data_ptr(),
            B, T, L, feats.shape[2], n_tx, tile_h, tile_w, Hp, Wp,
            *(float(c) for c in background), torch.cuda.current_stream(dev).cuda_stream,
        )
    k.check(rc, "render_tiles")
    render_tiles.launches += 1
    return out


render_tiles.launches = 0


def fitness_tiles(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background):
    """K1: lists + table + padded target [3, Hp, Wp] and weights [Hp, Wp]
    (0 on the padding) -> partials [B, T] of sum_px w * sum_ch (C - target)^2.

    Replaces ggs_tpu/ops/render_pallas.py:_fitness_tile_kernel (pallas_call
    in _fitness_partials). Bound by the walk's f32 arithmetic; the canvas
    never leaves registers, and the per-tile sum is fixed-order (no atomics),
    so the partials are the same bits on every run (csrc/walk.cu)."""
    if feats.device.type == "cpu":
        return fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background)
    B, T, L, dev = _check_lists(cnt, idx, feats, n_tx, tile_h, tile_w)
    Hp, Wp = (T // n_tx) * tile_h, n_tx * tile_w
    _require(target_p, "target_p", torch.float32, (3, Hp, Wp), dev)
    _require(w_p, "w_p", torch.float32, (Hp, Wp), dev)
    out = torch.empty((B, T), dtype=torch.float32, device=dev)
    k = build()
    with torch.cuda.device(dev):
        rc = k.lib.ggs_walk_fitness(
            cnt.data_ptr(), idx.data_ptr(), feats.data_ptr(), target_p.data_ptr(),
            w_p.data_ptr(), out.data_ptr(),
            B, T, L, feats.shape[2], n_tx, tile_h, tile_w, Hp, Wp,
            *(float(c) for c in background), torch.cuda.current_stream(dev).cuda_stream,
        )
    k.check(rc, "fitness_tiles")
    fitness_tiles.launches += 1
    return out


fitness_tiles.launches = 0


# -------------------------------------------------------- entry points


def _prepare(g9, H, W, k_sigma, precision, bin_capacity, tile_h, tile_w):
    """Renderer genomes -> (cnt, idx, feats, n_tx, n_ty) for one pass."""
    _check_precision(precision)
    if g9.dim() == 2:
        g9 = g9[None]
    B, N, C = g9.shape
    if C < codec.GENE_DIM:
        raise ValueError(f"expected >= 9 genome cols, got {C}")
    g9 = g9[..., : codec.GENE_DIM].to(torch.float32)
    p = codec.preprocess(g9, H, W, k_sigma)
    if precision == "exact-tight":
        p = codec.tighten_boxes_exact(p, k_sigma)
    n_tx = _cdiv(W, tile_w)
    n_ty = _cdiv(H, tile_h)
    cap = N if bin_capacity is None else min(bin_capacity, N)
    idx, cnt = bin_splats_dense(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, tile_h, tile_w, cap)
    return cnt, idx, _splat_feats_fast(p), n_tx, n_ty


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
) -> torch.Tensor:
    """Renderer genomes [B, N, 9] (or [N, 9]) -> [B, H, W, 3] (render_pallas)."""
    squeeze = g9.dim() == 2
    cnt, idx, feats, n_tx, _ = _prepare(
        g9, H, W, k_sigma, precision, bin_capacity, tile_h, tile_w
    )
    bg = tuple(float(c) for c in background)
    out = render_tiles(cnt, idx, feats, n_tx, tile_h, tile_w, bg)
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
) -> torch.Tensor:
    """Fused render + fitness: renderer genomes [B, N, 9] -> fitness [B]
    (fitness_pallas). Candidate canvases never reach device memory."""
    cnt, idx, feats, n_tx, n_ty = _prepare(
        g9, H, W, k_sigma, precision, bin_capacity, tile_h, tile_w
    )
    w_eff, denom = fitness_mod.weff_denom(weight_mask, boost_only, boost_beta, H, W)
    target_p, w_p = pad_planes(target, w_eff, n_ty * tile_h, n_tx * tile_w)
    partials = fitness_tiles(
        cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w,
        tuple(float(c) for c in background),
    )
    return torch.sum(partials, dim=1) / denom  # a 0-d CPU denom is a scalar: no sync
