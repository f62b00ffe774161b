"""The order in which the gradient kernels K6/K7 walk a tile's list
(csrc/walk_grad.cu), replayed in plain PyTorch on the CPU against the plain
versions' two-level replay (render_grad._grad_walk_plain):

* T pass: the list backward, T = 1 times (1 - f) splat by splat, with T
  stored at every chunk boundary; its end is T_total, and d(init) = g *
  T_total;
* G pass: chunk by chunk from the first, the chunk replayed backward from
  its stored T for each splat's T_k, then walked forward from the canvas
  before it (the init canvas or the background), forming the 9 sums.

Every f, T_k and canvas is the same operation in the same order as in the
two-level replay, so d(init) must be the same bits; the gradients sum the
same per-pixel terms, held to the kernels' summation-order tolerance (each
of the 9 rows within 1e-5 of its largest magnitude). At the list tile
heights the kernels walk (8, 16, 32, 64 rows of 128), from the background
and from an init canvas, with lists across several chunks."""
import numpy as np
import pytest
import torch

from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.ops import render_grad as trg
from torch_inputs import axes_genomes, pass_lists
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, B, N = 72, 200, 2, 40
KERNEL_CHUNK = 16  # walk_grad.cu kChunk: splats per transmittance checkpoint


def _checkpoint_walk(cnt, idx, feats, n_tx, tile_h, tile_w, background, g, init):
    """K6's walk order on every (image, tile) at once: -> (grads [B, 9, N],
    T_total [B, T, th, tw]). g: the cotangent tiles [B, 3, T, th, tw]."""
    Bc, T, _ = idx.shape
    t = torch.arange(T)
    xf = (((t % n_tx) * tile_w)[:, None, None] + torch.arange(tile_w)[None, None, :]).float()[None]
    yf = (((t // n_tx) * tile_h)[:, None, None] + torch.arange(tile_h)[None, :, None]).float()[None]
    zero = torch.zeros(())

    def splat(k):
        s = idx[:, :, k].long()
        pk = torch.gather(feats, 2, s[:, None, :].expand(Bc, 13, T))
        prm = [pk[:, r, :, None, None] for r in range(13)]
        cx, cy, sxx, sxy, syy, _, _, _, _, x0, x1, y0, y1 = prm
        qx, qy = xf - cx, yf - cy
        quad = sxx * (qx * qx) + 2.0 * sxy * (qx * qy) + syy * (qy * qy)
        m = (xf >= x0) & (xf <= x1) & (yf >= y0) & (yf <= y1) & (k < cnt)[:, :, None, None]
        return s, prm, qx, qy, torch.where(m, torch.exp(-0.5 * quad), zero)

    kmax = int(cnt.max())
    chunks = [range(c, min(c + KERNEL_CHUNK, kmax)) for c in range(0, kmax, KERNEL_CHUNK)]
    # T pass
    Tr = torch.ones((Bc, T, tile_h, tile_w))
    bounds = [None] * len(chunks)
    for ci in reversed(range(len(chunks))):
        bounds[ci] = Tr
        for k in reversed(chunks[ci]):
            _, prm, _, _, e = splat(k)
            Tr = Tr * (1.0 - prm[8] * e)
    t_total = Tr
    # G pass
    if init is None:
        canvas = [torch.full((Bc, T, tile_h, tile_w), float(c)) for c in background]
    else:
        it = rc._tiles_of(init, n_tx, tile_h, tile_w)
        canvas = [it[:, i] for i in range(3)]
    part = torch.zeros((Bc, T, trg.NGRAD, feats.shape[2]))
    for ks, Tr in zip(chunks, bounds):
        tks = {}
        for k in reversed(ks):
            _, prm, _, _, e = splat(k)
            tks[k] = Tr
            Tr = Tr * (1.0 - prm[8] * e)
        for k in ks:
            s, prm, qx, qy, e = splat(k)
            _, _, sxx, sxy, syy, rc_, gc, bc, a = prm[:9]
            f = a * e
            gT0, gT1, gT2 = g[:, 0] * tks[k], g[:, 1] * tks[k], g[:, 2] * tks[k]
            dLdf = gT0 * (rc_ - canvas[0]) + gT1 * (gc - canvas[1]) + gT2 * (bc - canvas[2])
            dLdq = -0.5 * f * dLdf
            d = torch.stack([
                dLdq * (-2.0) * (sxx * qx + sxy * qy), dLdq * (-2.0) * (syy * qy + sxy * qx),
                dLdq * qx * qx, dLdq * 2.0 * qx * qy, dLdq * qy * qy,
                gT0 * f, gT1 * f, gT2 * f, dLdf * e,
            ], dim=2).sum(dim=(-2, -1))
            part.scatter_(3, s[:, :, None, None].expand(Bc, T, trg.NGRAD, 1), d[..., None])
            omf = 1.0 - f
            canvas = [omf * ch + f * col for ch, col in zip(canvas, (rc_, gc, bc))]
    return part.sum(dim=1)[:, :, :-1], t_total


def _row_err(got, want):
    return (got - want).abs().amax(dim=(0, 2)) / want.abs().amax(dim=(0, 2)).clamp_min(1e-30)


@pytest.mark.parametrize("start", ["background", "init"])
@pytest.mark.parametrize("tile_h", trg.GRAD_TILE_HS)
def test_checkpoint_order_matches_two_level_replay(tile_h, start):
    tw = trg.GRAD_TILE_W
    g9 = tcodec.genome_to_renderer(torch.from_numpy(axes_genomes(7, B, N, H, W, max_scale=0.6)))
    cnt, idx, _, n_tx, n_ty = pass_lists(g9, H, W, 3.0, "exact-tight", None, tile_h, tw)
    assert int(cnt.max()) > 2 * KERNEL_CHUNK  # lists across three checkpoints
    feats = trg._splat_feats(tcodec.tighten_boxes_exact(tcodec.preprocess(g9, H, W, 3.0), 3.0))
    Hp, Wp = n_ty * tile_h, n_tx * tw
    rng = np.random.default_rng(tile_h)
    g_img = torch.from_numpy(rng.uniform(-1.0, 1.0, (B, 3, Hp, Wp)).astype(np.float32))
    bg = (1.0, 1.0, 1.0)
    canvas0 = torch.full((B, 3, Hp, Wp), 1.0)
    init = None
    if start == "init":
        init = torch.from_numpy(rng.uniform(0.05, 0.95, (B, 3, Hp, Wp)).astype(np.float32))
    want, want_dinit = trg.bwd_tiles_plain(cnt, idx, feats, g_img, n_tx, tile_h, tw, bg, init)
    if init is None:  # d(init) does not depend on the canvas: read T_total from the background
        _, want_dinit = trg.bwd_tiles_plain(cnt, idx, feats, g_img, n_tx, tile_h, tw, bg, canvas0)
    gt = rc._tiles_of(g_img, n_tx, tile_h, tw)
    got, t_total = _checkpoint_walk(cnt, idx, feats, n_tx, tile_h, tw, bg, gt, init)
    dinit = rc._untile(gt * t_total[:, None], n_tx)
    assert torch.equal(dinit, want_dinit)
    assert float(_row_err(got, want).max()) <= 1e-5
    assert float(want.abs().max()) > 0.0
