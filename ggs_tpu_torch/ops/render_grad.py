"""Differentiable tiled renderer: the exact analytic backward of the walk.

PyTorch/CUDA counterpart of `ggs_tpu/ops/render_grad.py` (exact tiers):

* `_splat_feats` (render_pallas.py:175): the raw table [B, 13, N+1] that the
  backward differentiates (unscaled sxx, sxy, syy), sentinel column N zero.
* `bwd_tiles` (K6) and `lossgrad_tiles` (K7): wrappers of the CUDA kernels in
  `csrc/walk_grad.cu`, each counting its launches in `profiling.COUNTS`
  and with a plain version beside it. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises.
* `RenderDiff`: the autograd Function of one pass, whose forward is K2
  (`render_cuda.render_tiles` on the folded table, as `fwd_only` reuses
  `_render_tile_kernel`) and whose backward is K6. A chained pass takes the
  previous pass's canvas as a differentiable input and K6 returns its
  cotangent d(init) = g * T_total.
* `render_diff` (`render_pallas_diff`) and `fused_value_and_grad`: the
  entry points. `render_diff` chains passes of at most
  `render_cuda.MAX_SPLATS` splats, each binned with its own capacity;
  `fused_value_and_grad` (K7, no init canvas) takes one pass and refuses
  more splats, as in the JAX package. Gradients chain through
  `codec.preprocess` and `genome_to_renderer` by ordinary autograd, as
  `jax.vjp(chain)` does.

The plain walks use the two-level replay of `_bwd_tile_kernel` (boundary
canvas every CHUNK splats, then each chunk replayed and walked backward);
the kernels checkpoint the transmittance instead and walk the gradients
forward (csrc/walk_grad.cu). Neither divides by (1 - f), which is 0 for
alpha 255 at a splat's centre, and both give every pixel the same values.
The kernels walk list tiles GRAD_TILE_W wide and any of GRAD_TILE_HS rows
high. Tiling changes nothing but the order of the sums, except under the
fast tier's corner cull, whose lists depend on the tile: there `_geometry`
takes JAX's tile height (`list_tile_h`, render_grad.py:670-678 and
:766-780), and elsewhere the port's GRAD_TILE_H. The fast tier's culls need
no kernel of their own: the entry points' (box, cull_eps, corner_cull) are
a `screen.box_tier`; with `cull_eps` the boxes are the eps-tight ones and
with `corner_cull` the lists drop the corner-culled pairs, and the exact
walks (K2', K6, K7) run over them, giving the exact gradients of the
culled render (render_grad.py:687-701, 791-814); from 256 tiles the cull
is band-level (render_cuda.bin_splats). A row slab (`y_origin`,
`out_rows`; the tile-sharded loss's building block) preprocesses against
the whole canvas, shifts into the slab before the culls (`screen.screen`)
and walks list tiles that divide its rows (render_grad.py:725-790).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from ..utils import profiling
from . import codec, fitness as fitness_mod, render_cuda, screen
from .render_cuda import _NFEAT, _cdiv, _require, pad_planes

NGRAD = 9  # dcx, dcy, dsxx, dsxy, dsyy, drc, dgc, dbc, da
# the plain walks' splats per boundary canvas, and JAX's _CHUNK in its
# VMEM rule for the tile height (render_grad.py:56)
CHUNK = 32
GRAD_TILE_W = 128  # the kernels' list tile width (walk_grad.cu kTileW)
GRAD_TILE_HS = (8, 16, 32, 64)  # the list tile heights the kernels walk
GRAD_TILE_H = 16  # the port's list tile height where the tile changes no result
JAX_VMEM_BUDGET = 10 * 1024 * 1024  # JAX's scratch budget for the tile height
# the gradient walks' pad_slots in the scatter binning's dense-route rule
# (render_grad.py:346, 540; the forward walks pass render_cuda.SCATTER_PAD)
GRAD_SCATTER_PAD = 40


def _splat_feats(p: codec.SplatScreen) -> torch.Tensor:
    """SplatScreen [B, N] -> raw table [B, 13, N+1] f32, column N zero."""
    with profiling.span("render.feats"):
        B, N = p.cx.shape
        feats = torch.stack(
            [
                p.cx, p.cy, p.sxx, p.sxy, p.syy, p.rc, p.gc, p.bc, p.a,
                p.x0.to(torch.float32), p.x1.to(torch.float32),
                p.y0.to(torch.float32), p.y1.to(torch.float32),
            ],
            dim=1,
        )
        return torch.cat([feats, feats.new_zeros((B, _NFEAT, 1))], dim=2).contiguous()


# ------------------------------------------------------ plain versions


def _grad_walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, head, init=None):
    """The backward walk in plain PyTorch over the same lists, slot k of
    every (image, tile) at once, with the kernels' two-level replay, from
    the background or the init canvas [B, 3, Hp, Wp].

    head(canvas planes) -> (g0, g1, g2, num) gives the image cotangent
    planes [B, T, th, tw] and K7's partials (None for K6). Returns
    (grads [B, 9, N], num, dinit [B, 3, Hp, Wp] = g * T_total, or None
    without init)."""
    B, T, _ = idx.shape
    N = feats.shape[2] - 1
    dev = feats.device
    t = torch.arange(T, device=dev)
    xf = ((t % n_tx) * tile_w)[:, None, None] + torch.arange(tile_w, device=dev)[None, None, :]
    yf = ((t // n_tx) * tile_h)[:, None, None] + torch.arange(tile_h, device=dev)[None, :, None]
    xf = xf.to(torch.float32)[None]  # [1, T, 1, tw]
    yf = yf.to(torch.float32)[None]  # [1, T, th, 1]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    kmax = int(cnt.max()) if cnt.numel() else 0

    def splat(k):
        """Slot k: list entry s [B, T], parameters [B, T, 1, 1], qx, qy, e."""
        s = idx[:, :, k].long()
        pk = torch.gather(feats, 2, s[:, None, :].expand(B, _NFEAT, T))
        prm = [pk[:, r, :, None, None] for r in range(_NFEAT)]
        cx, cy, sxx, sxy, syy, _, _, _, _, x0, x1, y0, y1 = prm
        qx = xf - cx
        qy = yf - cy
        quad = sxx * (qx * qx) + 2.0 * sxy * (qx * qy) + syy * (qy * qy)
        m = (xf >= x0) & (xf <= x1) & (yf >= y0) & (yf <= y1)
        m = m & (k < cnt)[:, :, None, None]
        return s, prm, qx, qy, torch.where(m, torch.exp(-0.5 * quad), zero)

    def blend(canvas, k):
        _, prm, _, _, e = splat(k)
        f = prm[8] * e
        omf = 1.0 - f
        return [omf * ch + f * col for ch, col in zip(canvas, prm[5:8])]

    # pass A: boundary canvases
    if init is None:
        canvas = [
            torch.full((B, T, tile_h, tile_w), float(c), dtype=torch.float32, device=dev)
            for c in background
        ]
    else:
        it = render_cuda._tiles_of(init, n_tx, tile_h, tile_w)  # [B, 3, T, th, tw]
        canvas = [it[:, i] for i in range(3)]
    chunks = [range(c, min(c + CHUNK, kmax)) for c in range(0, kmax, CHUNK)]
    bounds = []
    for ks in chunks:
        bounds.append(canvas)
        for k in ks:
            canvas = blend(canvas, k)
    g0, g1, g2, num = head(canvas)

    # pass B: each chunk replayed from its boundary, then walked backward
    part = torch.zeros((B, T, NGRAD, N + 1), dtype=torch.float32, device=dev)
    Tr = torch.ones((B, T, tile_h, tile_w), dtype=torch.float32, device=dev)
    for ks, cv in zip(reversed(chunks), reversed(bounds)):
        prevs = []
        for k in ks:
            prevs.append(cv)
            cv = blend(cv, k)
        for k, cp in zip(reversed(ks), reversed(prevs)):
            s, prm, qx, qy, e = splat(k)
            _, _, sxx, sxy, syy, rc, gc, bc, a = prm[:9]
            f = a * e
            gT0 = g0 * Tr
            gT1 = g1 * Tr
            gT2 = g2 * Tr
            dLdf = gT0 * (rc - cp[0]) + gT1 * (gc - cp[1]) + gT2 * (bc - cp[2])
            dLdq = -0.5 * f * dLdf
            d = torch.stack(
                [
                    dLdq * (-2.0) * (sxx * qx + sxy * qy),
                    dLdq * (-2.0) * (syy * qy + sxy * qx),
                    dLdq * qx * qx,
                    dLdq * 2.0 * qx * qy,
                    dLdq * qy * qy,
                    gT0 * f,
                    gT1 * f,
                    gT2 * f,
                    dLdf * e,
                ],
                dim=2,
            ).sum(dim=(-2, -1))  # [B, T, 9]
            # a tile lists a splat once, so each (image, tile, splat) is set once
            part.scatter_(3, s[:, :, None, None].expand(B, T, NGRAD, 1), d[..., None])
            Tr = Tr * (1.0 - f)
    dinit = None
    if init is not None:  # Tr is now the transmittance through the whole list
        dinit = render_cuda._untile(torch.stack([g0 * Tr, g1 * Tr, g2 * Tr], 1), n_tx)
    return part.sum(dim=1)[:, :, :N], num, dinit


def bwd_tiles_plain(cnt, idx, feats, g_img, n_tx, tile_h, tile_w, background, init=None):
    """Plain version of K6: image cotangent [B, 3, Hp, Wp] -> (grads
    [B, 9, N], dinit [B, 3, Hp, Wp] or None without init)."""
    gt = render_cuda._tiles_of(g_img, n_tx, tile_h, tile_w)  # [B, 3, T, th, tw]
    grads, _, dinit = _grad_walk_plain(
        cnt, idx, feats, n_tx, tile_h, tile_w, background,
        lambda canvas: (gt[:, 0], gt[:, 1], gt[:, 2], None), init,
    )
    return grads, dinit


def lossgrad_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background, scale):
    """Plain version of K7: -> (num partials [B, T] = sum_px w |clip(C) -
    target|^2, grads [B, 9, N] of scale/2 * sum_t num)."""
    tt = render_cuda._tiles_of(target_p, n_tx, tile_h, tile_w)  # [3, T, th, tw]
    wt = render_cuda._tiles_of(w_p, n_tx, tile_h, tile_w)  # [T, th, tw]

    def head(canvas):
        dr, dg, db = (torch.clamp(ch, 0.0, 1.0) - tt[i] for i, ch in enumerate(canvas))
        num = torch.sum((dr * dr + dg * dg + db * db) * wt, dim=(-2, -1))
        sw = scale * wt
        return sw * dr, sw * dg, sw * db, num

    grads, num, _ = _grad_walk_plain(cnt, idx, feats, n_tx, tile_h, tile_w, background, head)
    return num, grads


# ------------------------------------------------------------ wrappers


@functools.lru_cache(maxsize=None)
def _resident_blocks(fused: bool, device_index: int) -> int:
    """Blocks of the walk kernel the card holds at once: its checkpoint slots."""
    k = render_cuda.build()
    with torch.cuda.device(device_index):
        slots = k.grad.ggs_grad_resident_blocks(int(fused))
    if slots < 0:
        k.check(-slots, "ggs_grad_resident_blocks")
    return slots


def _launch_grad(fused, cnt, idx, feats, n_tx, tile_h, tile_w, background,
                 gimg=None, target_p=None, w_p=None, scale=0.0, init=None):
    B, T, L, dev = render_cuda._check_lists(cnt, idx, feats, n_tx, tile_h, tile_w)
    if tile_w != GRAD_TILE_W or tile_h not in GRAD_TILE_HS:
        raise ValueError(
            f"tile {tile_h}x{tile_w}: the gradient kernels walk tiles {GRAD_TILE_W} wide "
            f"and {GRAD_TILE_HS} high"
        )
    k = render_cuda.build()
    N1 = feats.shape[2]
    N = N1 - 1
    Hp, Wp = (T // n_tx) * tile_h, n_tx * tile_w
    if fused:
        _require(target_p, "target_p", torch.float32, (3, Hp, Wp), dev)
        _require(w_p, "w_p", torch.float32, (Hp, Wp), dev)
    else:
        _require(gimg, "g_img", torch.float32, (B, 3, Hp, Wp), dev)
    dinit = None
    if init is not None:
        _require(init, "init", torch.float32, (B, 3, Hp, Wp), dev)
        dinit = torch.empty((B, 3, Hp, Wp), dtype=torch.float32, device=dev)
    rows = k.grad.ggs_grad_sub_rows()
    S = tile_h // rows  # sub-tiles a list tile, a block each
    with torch.cuda.device(dev):
        slots = min(_resident_blocks(bool(fused), dev.index), B * T * S)
        # transmittance checkpoints per resident block, for a list as long as
        # L (>= every cnt; reading cnt.max() would sync the host every launch)
        max_chunks = max(1, _cdiv(L, k.grad.ggs_grad_chunk()))
        bound = torch.empty((slots, max_chunks, rows * tile_w), dtype=torch.float32, device=dev)
        spart = torch.empty((B, T, S, L, NGRAD), dtype=torch.float32, device=dev)
        gpart = torch.zeros((B, T, NGRAD, N), dtype=torch.float32, device=dev)
        grads = torch.empty((B, NGRAD, N), dtype=torch.float32, device=dev)
        num = nsub = None
        if fused:
            num = torch.empty((B, T), dtype=torch.float32, device=dev)
            nsub = torch.empty((B, T, S), dtype=torch.float32, device=dev)

        def ptr(x):
            return None if x is None else x.data_ptr()

        rc = k.grad.ggs_grad_walk(
            int(fused), cnt.data_ptr(), idx.data_ptr(), feats.data_ptr(), ptr(gimg), ptr(init),
            ptr(dinit), ptr(target_p), ptr(w_p), float(scale), ptr(num), ptr(nsub),
            spart.data_ptr(), gpart.data_ptr(), grads.data_ptr(), bound.data_ptr(), slots,
            max_chunks, B, T, L, N1, N, n_tx, tile_h, Hp, Wp, *(float(c) for c in background),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    k.check(rc, "lossgrad_tiles" if fused else "bwd_tiles")
    return num, grads, dinit


def bwd_tiles(cnt, idx, feats, g_img, n_tx, tile_h, tile_w, background, init=None):
    """K6: lists + raw table + image cotangent [B, 3, Hp, Wp] -> (grads
    [B, 9, N] of sum_px g . canvas, straight through the final clamp; dinit
    [B, 3, Hp, Wp] = g * T_total, the cotangent of the init canvas a chained
    pass starts from, or None without init).

    Replaces ggs_tpu/ops/render_grad.py:_bwd_tile_kernel(fused=False)
    (pallas_call in _make_screen_render.bwd_grads). Bound by the
    arithmetic of its walks: transmittance checkpoints, then each chunk
    replayed and walked forward (csrc/walk_grad.cu)."""
    if feats.device.type == "cpu":
        return bwd_tiles_plain(cnt, idx, feats, g_img, n_tx, tile_h, tile_w, background, init)
    _, grads, dinit = _launch_grad(False, cnt, idx, feats, n_tx, tile_h, tile_w, background,
                                   gimg=g_img, init=init)
    profiling.count("K6")
    profiling.count("K6-init", init is not None)
    return grads, dinit


def lossgrad_tiles(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background, scale):
    """K7: lists + raw table + padded target [3, Hp, Wp] and weights
    [Hp, Wp] (0 on the padding) -> (num partials [B, T] of sum_px w |clip(C)
    - target|^2, grads [B, 9, N] with the cotangent scale * w * (clip(C) -
    target)); scale 2 gives d(sum_t num_b)/d(params_b).

    Replaces ggs_tpu/ops/render_grad.py:_bwd_tile_kernel(fused=True)
    (pallas_call in _make_screen_lossgrad.run): forward walk, on-chip loss
    head and backward walk in one launch. Bound as K6 (csrc/walk_grad.cu)."""
    if feats.device.type == "cpu":
        return lossgrad_tiles_plain(
            cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, background, scale
        )
    num, grads, _ = _launch_grad(
        True, cnt, idx, feats, n_tx, tile_h, tile_w, background,
        target_p=target_p, w_p=w_p, scale=scale,
    )
    profiling.count("K7")
    return num, grads


# -------------------------------------------------------- autograd


class RenderDiff(torch.autograd.Function):
    """(init canvas or None, SplatScreen fields) -> padded canvas
    [B, 3, Hp, Wp] of one pass: forward K2 on the folded table from the
    background or init, backward K6 on the raw table and the same lists,
    with d(init) = g * T_total for a chained pass (screen_render with
    has_init, render_grad.py:456-475)."""

    @staticmethod
    def forward(ctx, init, cx, cy, sxx, sxy, syy, rc, gc, bc, a, x0, x1, y0, y1, geom):
        p = codec.SplatScreen(cx, cy, sxx, sxy, syy, rc, gc, bc, a, x0, x1, y0, y1)
        n_tx, _, tile_h, tile_w, _, bg, _ = geom
        idx, cnt = _bin(p, geom)
        feats = render_cuda._splat_feats_fast(p)
        with profiling.span("render.walk"):
            canvas = render_cuda.render_tiles(cnt, idx, feats, n_tx, tile_h, tile_w, bg, init=init)
        ctx.save_for_backward(_splat_feats(p), cnt, idx, init)
        ctx.geom = geom
        return canvas

    @staticmethod
    def backward(ctx, g_img):
        feats, cnt, idx, init = ctx.saved_tensors
        n_tx, _, tile_h, tile_w, _, bg, _ = ctx.geom
        with profiling.span("render.grad"):
            g, dinit = bwd_tiles(cnt, idx, feats, g_img.contiguous(), n_tx, tile_h, tile_w, bg,
                                 init)
        return (dinit,) + tuple(g[:, i] for i in range(NGRAD)) + (None,) * 5


class _FusedNum(torch.autograd.Function):
    """SplatScreen fields -> num [B] (sum_px w |clip(C) - target|^2) by K7,
    which also gives d(num_b)/d(params_b); the backward scales those by the
    incoming cotangent of each image."""

    @staticmethod
    def forward(ctx, cx, cy, sxx, sxy, syy, rc, gc, bc, a, x0, x1, y0, y1, target_p, w_p, geom):
        p = codec.SplatScreen(cx, cy, sxx, sxy, syy, rc, gc, bc, a, x0, x1, y0, y1)
        n_tx, _, tile_h, tile_w, _, bg, _ = geom
        idx, cnt = _bin(p, geom)
        feats = _splat_feats(p)
        with profiling.span("render.grad"):
            # cotangent scale 2: d(w |C - target|^2)/dC = 2 w (C - target)
            num, grads = lossgrad_tiles(cnt, idx, feats, target_p, w_p, n_tx, tile_h, tile_w, bg,
                                        2.0)
            ctx.save_for_backward(grads)
            return torch.sum(num, dim=1)

    @staticmethod
    def backward(ctx, g_num):
        (grads,) = ctx.saved_tensors
        g = grads * g_num[:, None, None]
        return tuple(g[:, i] for i in range(NGRAD)) + (None,) * 7


def list_tile_h(cap: int, out_rows: Optional[int] = None) -> int:
    """JAX's gradient list tile height for a list capacity cap: the tallest
    of 64, 32, 16 rows whose backward scratch fits its VMEM budget, else 8
    (render_grad.py:670-678 in fused_value_and_grad, :766-780 in
    render_pallas_diff, there from the whole cap); on a row slab of out_rows
    rows only the heights that divide it (:770-772)."""
    mc = _cdiv(cap, CHUNK)
    for th in (64, 32, 16):
        if out_rows is not None and (out_rows < th or out_rows % th):
            continue
        if th * GRAD_TILE_W * 4 * ((mc + 1) * 3 + 3 * CHUNK + CHUNK) <= JAX_VMEM_BUDGET:
            return th
    return 8


def _geometry(H, W, N, bin_capacity, background, t: screen.Tier, n_total=None, out_rows=None):
    """The walks' geometry (n_tx, n_ty, tile_h, tile_w, cap, background,
    corner_eps) of a pass of N splats out of n_total (default N) over H
    canvas rows, or a slab of out_rows, under tier t. Under the corner cull
    the lists depend on the tile, so its height is JAX's (list_tile_h of the
    whole cap); otherwise the port's GRAD_TILE_H, or 8 rows on a slab that
    16 does not divide."""
    n_total = N if n_total is None else n_total
    cap, whole = (n if bin_capacity is None else min(bin_capacity, n) for n in (N, n_total))
    rows = H if out_rows is None else out_rows
    if t.corner_eps is not None:
        tile_h = list_tile_h(whole, out_rows)
    else:
        tile_h = GRAD_TILE_H if rows % GRAD_TILE_H == 0 or out_rows is None else 8
    return (_cdiv(W, GRAD_TILE_W), _cdiv(rows, tile_h), tile_h, GRAD_TILE_W, cap,
            tuple(float(c) for c in background), t.corner_eps)


def _bin(p: codec.SplatScreen, geom):
    """The walks' lists of p's boxes, corner-culled when geom says so."""
    n_tx, n_ty, tile_h, tile_w, cap, _, corner_eps = geom
    corner = None if corner_eps is None else render_cuda._corner_params(p, corner_eps)
    return render_cuda.bin_splats(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, tile_h, tile_w, cap, corner,
                                  pad_slots=GRAD_SCATTER_PAD)


def render_diff(
    g9: torch.Tensor,
    H: int,
    W: int,
    k_sigma: float = 3.0,
    background: Sequence[float] = (1.0, 1.0, 1.0),
    bin_capacity: Optional[int] = None,
    y_origin=None,
    out_rows: Optional[int] = None,
    cull_eps: Optional[float] = None,
    corner_cull: bool = False,
    box: str = "reference",  # "reference" | "tight" (exact-tight tier)
) -> torch.Tensor:
    """Differentiable render: renderer genomes [B, N, 9] (or [N, 9]) ->
    [B, H, W, 3] (render_pallas_diff). Forward K2, backward K6, in passes
    of at most render_cuda.MAX_SPLATS splats chained through the canvas,
    each binned with cap = min(bin_capacity, its N) (render_grad.py:808-826).
    cull_eps: the fast tier's eps-tight boxes; corner_cull (with cull_eps):
    its corner cull at binning. The gradients are the exact gradients of
    that culled render; a splat with alpha <= eps gets exactly zero.
    (y_origin, out_rows): only the out_rows canvas rows from global row
    y_origin -> [B, out_rows, W, 3], the splats shifted into the slab before
    the culls (d(cy - y_origin)/d(cy) = 1) and walked on list tiles that
    divide out_rows; summed over a canvas's slabs, the gradients of a loss
    of the rows are those of the whole canvas."""
    squeeze = g9.dim() == 2
    if squeeze:
        g9 = g9[None]
    y_origin = 0 if y_origin is None else int(y_origin)
    rows = H if out_rows is None else int(out_rows)
    t = screen.box_tier(box, cull_eps, corner_cull)
    p = screen.screen(g9, H, W, k_sigma, t, y_origin)
    canvas = None
    for pc in screen.passes(p):
        geom = _geometry(H, W, pc.cx.shape[1], bin_capacity, background, t,
                         n_total=g9.shape[1], out_rows=out_rows)
        canvas = RenderDiff.apply(canvas, *pc, geom)
    img = canvas[:, :, :rows, :W].permute(0, 2, 3, 1)
    return img[0] if squeeze else img


def fused_value_and_grad(
    g_axes: torch.Tensor,
    target: torch.Tensor,
    weight_mask: Optional[torch.Tensor],
    H: int,
    W: int,
    *,
    boost_only: bool = False,
    boost_beta: float = 1.0,
    k_sigma: float = 3.0,
    background: Sequence[float] = (1.0, 1.0, 1.0),
    bin_capacity: Optional[int] = None,
    cull_eps: Optional[float] = None,
    corner_cull: bool = False,
    box: str = "reference",  # "reference" | "tight" (exact-tight tier)
):
    """((loss, fits), grads) for loss = mean(fitness(render(g), target)),
    one K7 launch for the whole batch (fused_value_and_grad, :603). One
    pass: above render_cuda.MAX_SPLATS splats it raises ValueError, as in
    the JAX package (gradient.make_value_and_grad then takes render_diff).

    g_axes [B, N, 9] axes-angle genomes; target [H, W, 3]; weight_mask
    [H, W] or None (the scoring modes of fitness.weff_denom). The grads
    [B, N, 9] chain through the codec by autograd. cull_eps and
    corner_cull as in render_diff: K7 walks the culled lists."""
    B, N = int(g_axes.shape[0]), int(g_axes.shape[1])
    if N > render_cuda.MAX_SPLATS:
        raise ValueError(
            f"fused_value_and_grad takes N <= {render_cuda.MAX_SPLATS} (got {N}); "
            "render_diff chains passes"
        )
    t = screen.box_tier(box, cull_eps, corner_cull)
    geom = _geometry(H, W, N, bin_capacity, background, t)
    n_tx, n_ty, tile_h, tile_w = geom[:4]
    w_eff, denom = fitness_mod.weff_denom(weight_mask, boost_only, boost_beta, H, W)
    target_p, w_p = pad_planes(target, w_eff, n_ty * tile_h, n_tx * tile_w)
    g = g_axes.detach().to(torch.float32).requires_grad_(True)
    with torch.enable_grad():
        p = screen.screen(codec.genome_to_renderer(g), H, W, k_sigma, t)
        num = _FusedNum.apply(*p, target_p, w_p, geom)
        fits = num / denom  # a 0-d CPU denom is a scalar: no copy, no sync
        loss = torch.mean(fits)
        (grads,) = torch.autograd.grad(loss, g)
    return (loss.detach(), fits.detach()), grads
