"""The order in which the forward walk kernels (csrc/walk.cu: K1, K2, K3 and
K1-bf16) walk a list tile, replayed in plain PyTorch on the CPU against the
plain versions (render_cuda._walk_plain, fitness_tiles_plain):

* a block walks a sub-tile of 4 rows x 128 columns, and every sub-tile of a
  tile walks the tile's whole list, from the background or the init canvas
  (rounded to bf16 in mode 2);
* a listed splat whose rows miss the sub-tile's four is skipped (dropped
  while it is staged, by a ballot that keeps the list's order), and so is
  one whose columns miss a warp's 32 (a warp-uniform test); otherwise all
  four rows blend, each pixel outside
  the box with f = 0 taken by a select, which must leave it unchanged bit
  for bit ((1-0) C + 0 c == C, C + 0 (c - C) == C);
* mode 2 rounds every operation to bf16 as the packed bf16x2 instructions
  do: the f32 result rounded (tests/test_torch_bf16_pairs.py);
* the fitness partial of a tile: each thread sums its 4 rows in order, a
  warp its 32 columns by a shuffle tree (xor 16, 8, 4, 2, 1), the block its
  4 warps in order, and the tile its sub-tiles in order.

The canvases must equal the plain walk's bit for bit in all three modes;
the partials agree with fitness_tiles_plain to the kernels' tolerance
(rtol 5e-5: the same per-pixel terms summed in another order). The lists
hold a splat of alpha 0 (log2(alpha) = -inf in the fast table), one of
alpha 255 centred on a pixel, and the table's sentinel column, at list
tiles 8-64 rows high on an odd canvas."""
import numpy as np
import pytest
import torch

from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import render_cuda as rc
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, B, N = 72, 200, 2, 40
SUB_ROWS = 4  # walk.cu kRows: the rows of a sub-tile
WARP = 32
TILE_W = 128
BG = (1.0, 0.5, 0.25)


def _screen():
    """Screen-space splats: splat 0 of alpha 0, the last two of alpha 255
    centred on pixels (W-1, H-1) and (0, 0), painted last."""
    g = axes_genomes(11, B, N, H, W, max_scale=0.5)
    g[:, 0, 8] = 0.0
    g[:, N - 2, [0, 1, 8]] = (1.0, 1.0, 255.0)
    g[:, N - 1, [0, 1, 8]] = (0.0, 0.0, 255.0)
    return tcodec.preprocess(tcodec.genome_to_renderer(torch.from_numpy(g)), H, W, 3.0)


def _lists(p, n_tx, n_ty, tile_h):
    """Every tile's ascending list, then the sentinel column N listed too."""
    idx, cnt = rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, tile_h, TILE_W, N)
    idx = torch.cat([idx, torch.full((B, n_tx * n_ty, 1), N, dtype=torch.int32)], dim=2)
    return cnt + 1, idx.contiguous()


def _bf(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _replay(cnt, idx, feats, n_tx, tile_h, mode, init):
    """walk.cu's order -> the clamped (r, g, b) planes, each per sub-tile
    [B, T, S, 4, 128]."""
    T = idx.shape[1]
    S = tile_h // SUB_ROWS
    t = torch.arange(T)
    xf = (((t % n_tx) * TILE_W)[:, None, None] + torch.arange(TILE_W)[None, None, :]).float()[None]
    yf = (((t // n_tx) * tile_h)[:, None, None] + torch.arange(tile_h)[None, :, None]).float()[None]
    sub = (B, T, S, SUB_ROWS, TILE_W)
    yb = yf.reshape(1, T, S, SUB_ROWS, 1)[:, :, :, :1]  # each sub-tile's first row
    ye = yb + (SUB_ROWS - 1)
    wx0 = (xf - (torch.arange(TILE_W) % WARP).float()).reshape(1, T, 1, 1, TILE_W)  # warp's first
    wx1 = wx0 + (WARP - 1)
    r16 = _bf if mode == "bf16" else (lambda v: v)
    if init is None:
        canvas = [torch.full(sub, r16(torch.tensor(c)).item()) for c in BG]
    else:
        it = rc._tiles_of(init, n_tx, tile_h, TILE_W)
        canvas = [r16(it[:, i]).reshape(sub) for i in range(3)]
    zero = torch.zeros(())
    for k in range(int(cnt.max())):
        s = idx[:, :, k].long()
        pk = torch.gather(feats, 2, s[:, None, :].expand(B, 13, T))
        cx, cy, nsxx, nsxy, nsyy, col_r, col_g, col_b, a, x0, x1, y0, y1 = (
            pk[:, r, :, None, None] for r in range(13))
        # per pixel, on the plain walk's layout [B, T, tile_h, 128]
        qx, qy = xf - cx, yf - cy
        if mode == "fast":
            e = torch.exp2(nsxx * (qx * qx) + (nsxy * (qx * qy) + (nsyy * (qy * qy) + a)))
            inb = (xf > x0) & (xf < x1) & (yf > y0) & (yf < y1)
        elif mode == "exact":
            e = torch.exp(nsxx * (qx * qx) + nsxy * (qx * qy) + nsyy * (qy * qy)) * a
            inb = (xf >= x0) & (xf <= x1) & (yf >= y0) & (yf <= y1)
        else:  # each bf16 operation: the f32 result rounded
            qx, qy = _bf(qx), _bf(qy)
            txx = _bf(_bf(nsxx) * _bf(qx * qx))
            quad = _bf(txx + _bf(_bf(nsxy) * _bf(qx * qy)))
            quad = _bf(quad + _bf(_bf(nsyy) * _bf(qy * qy)))
            e = _bf(torch.exp(quad.to(torch.bfloat16)).float() * _bf(a))
            inb = (xf >= x0) & (xf <= x1) & (yf >= y0) & (yf <= y1)
        f = torch.where(inb, e, zero).reshape(sub)  # a select, not a multiply
        sk = lambda v: v[..., None]  # noqa: E731  [B, T, 1, 1] -> [B, T, 1, 1, 1]
        if mode == "fast":
            skip = ~((sk(y0) < ye) & (sk(y1) > yb)) | ~((sk(x0) < wx1) & (sk(x1) > wx0))
            new = [ch + f * (sk(c) - ch) for ch, c in zip(canvas, (col_r, col_g, col_b))]
        elif mode == "exact":
            skip = (sk(y1) < yb) | (sk(y0) > ye) | (sk(x1) < wx0) | (sk(x0) > wx1)
            new = [(1.0 - f) * ch + f * sk(c) for ch, c in zip(canvas, (col_r, col_g, col_b))]
        else:
            skip = (sk(y1) < yb) | (sk(y0) > ye) | (sk(x1) < wx0) | (sk(x0) > wx1)
            omf = _bf(1.0 - f)
            new = [_bf(_bf(omf * ch) + _bf(f * _bf(sk(c))))
                   for ch, c in zip(canvas, (col_r, col_g, col_b))]
        skip = skip | (k >= cnt)[:, :, None, None, None]  # the walk stops at cnt
        canvas = [torch.where(skip, ch, nw) for ch, nw in zip(canvas, new)]
    return [torch.clamp(ch, 0.0, 1.0) for ch in canvas]


def _kernel_sums(planes, target_p, w_p, n_tx, tile_h):
    """The fitness partials [B, T] in the kernel's order."""
    T = planes[0].shape[1]
    S = tile_h // SUB_ROWS
    tt = rc._tiles_of(target_p, n_tx, tile_h, TILE_W).reshape(3, 1, T, S, SUB_ROWS, TILE_W)
    wt = rc._tiles_of(w_p, n_tx, tile_h, TILE_W).reshape(1, T, S, SUB_ROWS, TILE_W)
    dr, dg, db = (planes[i] - tt[i] for i in range(3))
    v = (dr * dr + dg * dg + db * db) * wt  # [B, T, S, 4, 128]
    acc = torch.zeros(v.shape[:3] + (TILE_W,))
    for r in range(SUB_ROWS):  # a thread's rows in order
        acc = acc + v[:, :, :, r]
    acc = acc.reshape(*acc.shape[:3], TILE_W // WARP, WARP)
    lane = torch.arange(WARP)
    for off in (16, 8, 4, 2, 1):  # the shuffle tree; every lane ends with the same bits
        acc = acc + acc[..., lane ^ off]
    red = acc[..., 0]  # [B, T, S, 4]
    s = torch.zeros(red.shape[:3])
    for w in range(TILE_W // WARP):  # the warps in order
        s = s + red[..., w]
    total = torch.zeros(s.shape[:2])
    for u in range(S):  # the sub-tiles in order
        total = total + s[..., u]
    return total


@pytest.mark.parametrize("start", ["background", "init"])
@pytest.mark.parametrize("tile_h", [8, 16, 32, 64])
@pytest.mark.parametrize("mode", ["exact", "fast", "bf16"])
def test_subtile_order_matches_plain_walk(mode, tile_h, start):
    p = _screen()
    n_tx, n_ty = -(-W // TILE_W), -(-H // tile_h)
    Hp, Wp = n_ty * tile_h, n_tx * TILE_W
    cnt, idx = _lists(p, n_tx, n_ty, tile_h)
    feats = rc._splat_feats_turbo(p) if mode == "fast" else rc._splat_feats_fast(p)
    rng = np.random.default_rng(tile_h)
    init = None
    if start == "init":
        init_np = rng.uniform(0.05, 0.95, (B, 3, Hp, Wp)).astype(np.float32)
        init_np[:, :, ::7, ::5] = 0.0
        init_np[:, :, 3::7, 2::5] = 1.0
        init = torch.from_numpy(init_np)
    # the edge cases are listed: alpha 0 (and -inf in the fast table), the
    # alpha-255 centres, the sentinel
    ks = [idx[b][:, :int(cnt[b].max())] for b in range(B)]
    assert all(bool((k == s).any()) for k in ks for s in (0, N - 2, N - 1, N))
    assert mode != "fast" or bool(torch.isneginf(feats[:, 8, 0]).all())

    planes = _replay(cnt, idx, feats, n_tx, tile_h, mode, init)
    want = rc._walk_plain(cnt, idx, feats, n_tx, tile_h, TILE_W, BG, mode, init)
    T = idx.shape[1]
    for got, ref in zip(planes, want):
        assert torch.equal(got.reshape(B, T, tile_h, TILE_W), ref)
    # alpha 255 at a pixel centre paints that pixel its own colour exactly
    # (the exact walk: 1 - 1 = 0, so C = 0 * C + 1 * c)
    if mode == "exact":
        canvas = rc._untile(torch.stack(want, 1), n_tx)
        for b in range(B):
            assert float(canvas[b, 0, H - 1, W - 1]) == float(p.rc[b, N - 2])
            assert float(canvas[b, 0, 0, 0]) == float(p.rc[b, N - 1])

    target_p, w_p = rc.pad_planes(torch.from_numpy(image(3, H, W)),
                                  torch.from_numpy(weights(4, H, W)), Hp, Wp)
    got = _kernel_sums(planes, target_p, w_p, n_tx, tile_h)
    ref = rc.fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, TILE_W, BG, mode,
                                 init)
    torch.testing.assert_close(got, ref, rtol=5e-5, atol=0)
    assert float(ref.min()) > 0.0
