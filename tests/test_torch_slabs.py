"""The port's row slabs (ggs_tpu_torch/ops/render_cuda.py: fitness_partial,
render_rows, shift_rows; ops/render_grad.render_diff(y_origin, out_rows);
ops/ssim.ssim_sum_rows) against the JAX package's fitness_pallas_partial,
render_rows_pallas, render_pallas_diff and ssim_sum_rows (Pallas in
interpret mode) on the same float32 renderer genomes (JAX's codec), on the
CPU, where the port's kernel wrappers take their plain versions.

The slabs: the top, a middle one and the bottom one of a 64-row canvas, 16
and 32 rows high, with splats wholly above and wholly below a slab; every
precision tier, the fast one with the corner cull; and a slab of 256 tiles
(128 rows of 8-row tiles at 2048 columns), where the binning takes the
scatter route on the shifted boxes.

Tolerances, with their sources:
* canvases: atol 4e-6, the port's cross-package canvas tolerance
  (tests/test_torch_render.py), or the largest difference of the two
  packages' full canvases of the same genomes where that is larger (these
  inputs' 1-px splats at alpha up to 255 put the two libraries' expf ulps
  at 4.2e-6 exact and 9.5e-6 fast on the full canvas): a slab adds no
  difference of its own; the top slab equals the full canvas's rows bit
  for bit (no shift);
* fitness partials: rtol 5e-5, the cross-package fitness tolerance
  (tests/test_torch_render.py:127); summed over the canvas's slabs against
  the port's full fitness x denominator rtol 1e-6, atol 1e-7
  (tests/test_sharding.py:142);
* gradients: rtol 1e-3, atol 1e-7 (tests/test_render_grad.py:40); the
  differentiable slab's canvas equals render_rows' bit for bit;
* SSIM partials over the window count: atol 1e-5 (tests/test_torch_ssim.py);
* the lists: equal as integers (cnt, and idx below cnt).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import codec as jcodec
from ggs_tpu.ops import render_grad as jrg
from ggs_tpu.ops import render_pallas as rp
from ggs_tpu.ops import ssim as jssim
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import fitness as tfitness
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.ops import render_grad as trg
from ggs_tpu_torch.ops import screen as tscreen
from ggs_tpu_torch.ops import ssim as tssim
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, N, B = 64, 256, 24, 2
CANVAS_ATOL = 4e-6
FIT_RTOL = 5e-5
GRAD_TOL = dict(rtol=1e-3, atol=1e-7)
TGT, WM = image(40, H, W), weights(41, H, W)
# (y_origin, slab rows): the top, a middle and the bottom slab, 16 and 32 rows
SLABS = ((0, 32), (16, 16), (48, 16))
TIERS = (("highest", False), ("exact-tight", False), ("fast", True), ("bf16", False))


def _genomes(seed=0, b=B, n=N, h=H, w=W):
    """Axes genomes with two small splats wholly inside the top 8 rows and
    two wholly inside the bottom 8: above and below every middle slab."""
    g = axes_genomes(seed, b, n, h, w)
    g[:, :4, 2:4] = 0.0  # scale 1 px: a k-sigma box of a few pixels
    g[:, :2, 1] = 3.0 / (h - 1)
    g[:, 2:4, 1] = (h - 4.0) / (h - 1)
    return g


def _g9(g):
    """The renderer genome both packages read (JAX's codec)."""
    return np.array(jcodec.genome_to_renderer(jnp.asarray(g)))


G9 = _g9(_genomes())


@pytest.mark.parametrize("precision,corner", TIERS, ids=[t[0] for t in TIERS])
def test_fitness_partial_matches_jax(precision, corner):
    """Each slab's partial against fitness_pallas_partial, and the slabs of
    the canvas summed against the port's full fitness x denominator."""
    g9 = torch.from_numpy(G9)
    w_eff, denom = tfitness.weff_denom(torch.from_numpy(WM), False, 1.0, H, W)
    for y0, hs in SLABS:
        got = rc.fitness_partial(g9, torch.from_numpy(TGT[y0:y0 + hs]), w_eff[y0:y0 + hs], H, W,
                                 y0, tile_h=hs, precision=precision, corner_cull=corner)
        want = rp.fitness_pallas_partial(
            jnp.asarray(G9), jnp.asarray(TGT[y0:y0 + hs]), jnp.asarray(WM[y0:y0 + hs]), H, W,
            jnp.int32(y0), tile_h=hs, tile_w=128, interpret=True, precision=precision,
            corner_cull=corner)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FIT_RTOL,
                                   err_msg=f"slab {y0}+{hs}")
    if precision == "fast":
        return  # the full fast fitness takes K4's boxes, another rule (render_cuda.fitness)
    parts = sum(rc.fitness_partial(g9, torch.from_numpy(TGT[y:y + 16]), w_eff[y:y + 16], H, W, y,
                                   tile_h=16, precision=precision)
                for y in range(0, H, 16))
    full = rc.fitness(g9, torch.from_numpy(TGT), torch.from_numpy(WM), H, W, tile_h=16,
                      precision=precision) * denom
    np.testing.assert_allclose(parts.numpy(), full.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("precision,corner", TIERS[:3], ids=[t[0] for t in TIERS[:3]])
def test_render_rows_matches_jax(precision, corner):
    """render_rows against render_rows_pallas on the bottom slab and a slab
    past the canvas (its rows beyond H are background); the top slab
    equals the port's full canvas rows in bits."""
    g9 = torch.from_numpy(G9)
    full = rc.render(g9, H, W, tile_h=32, precision=precision, corner_cull=corner)
    full_j = rp.render_pallas(jnp.asarray(G9), H, W, tile_h=32, interpret=True,
                              precision=precision, corner_cull=corner)
    atol = max(CANVAS_ATOL, float(np.abs(full.numpy() - np.asarray(full_j)).max()))
    for y0, rows in ((32, 32), (48, 32)):
        got = rc.render_rows(g9, H, W, y0, rows, precision=precision, corner_cull=corner)
        want = rp.render_rows_pallas(jnp.asarray(G9), H, W, jnp.int32(y0), rows, interpret=True,
                                     precision=precision, corner_cull=corner)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
        if y0 + rows > H:
            assert (got[:, H - y0:] == 1.0).all()
    top = rc.render_rows(g9, H, W, 0, 32, precision=precision, corner_cull=corner)
    assert torch.equal(top, full[:, :32])


HD, WD = 48, 128  # the gradient slabs' canvas
G9D = _g9(_genomes(seed=3, b=1, n=12, h=HD, w=WD))
# (box, cull_eps, corner cull, y_origin, slab rows): a middle and a bottom slab
# (the reference box's slab gradients are held against JAX's by
# tests/test_torch_sharding.py through the tile-sharded loss)
DIFF_CASES = {"tight_bottom": ("tight", None, False, 16, 32),
              "fast_corner_middle": ("reference", 2e-3, True, 16, 16)}


@pytest.mark.parametrize("name", list(DIFF_CASES))
def test_render_diff_slab_matches_jax(name):
    """render_diff(y_origin, out_rows): the gradients of the slab's masked
    SSE with respect to the renderer genome against render_pallas_diff on
    the same slab; in the exact tiers its canvas equals render_rows' (the
    same walk over the same boxes, which test_render_rows_matches_jax holds
    against JAX's; under fast, render_diff walks the exact walk over the
    culled lists, render_rows the exp2 one)."""
    box, cull, corner, y0, rows = DIFF_CASES[name]
    tgt = image(42, HD, WD)[y0:y0 + rows]
    wm = weights(43, HD, WD)[y0:y0 + rows]

    def jloss(g):
        img = jrg.render_pallas_diff(g, HD, WD, interpret=True, y_origin=jnp.int32(y0),
                                     out_rows=rows, cull_eps=cull, corner_cull=corner, box=box)
        return jnp.sum((img - tgt[None]) ** 2 * wm[None, :, :, None])

    grad_j = jax.grad(jloss)(jnp.asarray(G9D))
    gt = torch.from_numpy(G9D).requires_grad_(True)
    img = trg.render_diff(gt, HD, WD, y_origin=y0, out_rows=rows, cull_eps=cull,
                          corner_cull=corner, box=box)
    sse = (img - torch.from_numpy(tgt)[None]) ** 2 * torch.from_numpy(wm)[None, :, :, None]
    (grad,) = torch.autograd.grad(torch.sum(sse), gt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), **GRAD_TOL)
    if cull is None:
        want = rc.render_rows(torch.from_numpy(G9D), HD, WD, y0, rows,
                              precision="exact-tight" if box == "tight" else "highest")
        assert torch.equal(img.detach(), want)


def test_render_diff_slabs_sum_to_full_gradient():
    """The gradients of the slabs' SSE summed over the canvas equal the full
    canvas's (the tile-sharded loss's all-reduce), exact tier."""
    g9 = torch.from_numpy(G9[:1])

    def grad(**kw):
        gt = g9.clone().requires_grad_(True)
        img = trg.render_diff(gt, H, W, **kw)
        rows = slice(kw.get("y_origin", 0), kw.get("y_origin", 0) + img.shape[1])
        (g,) = torch.autograd.grad(torch.sum((img - torch.from_numpy(TGT[rows])[None]) ** 2), gt)
        return g

    parts = sum(grad(y_origin=y, out_rows=16) for y in range(0, H, 16))
    np.testing.assert_allclose(parts.numpy(), grad().numpy(), **GRAD_TOL)


def test_ssim_sum_rows_matches_jax():
    """ssim_sum_rows on each 16-row slab with its 10-row halo (the bottom
    slab's wrapped around and left out), against JAX's; summed over the
    slabs it gives the canvas's mean SSIM."""
    imgs = np.clip(TGT[None] + 0.1 * np.random.default_rng(42).standard_normal((2, H, W, 3)),
                   0.0, 1.0).astype(np.float32)
    n_win = (H - 10) * (W - 10) * 3
    total = 0.0
    for y0 in range(0, H, 16):
        ext_rows = [(y0 + r) % H for r in range(26)]
        ie, te = imgs[:, ext_rows], TGT[ext_rows]
        got = tssim.ssim_sum_rows(torch.from_numpy(ie), torch.from_numpy(te), y0, H).numpy()
        want = np.asarray(jssim.ssim_sum_rows(jnp.asarray(ie), jnp.asarray(te), y0, H))
        np.testing.assert_allclose(got / n_win, want / n_win, rtol=0, atol=1e-5)
        total = total + got
    full = tssim.ssim(torch.from_numpy(imgs), torch.from_numpy(TGT)).numpy()
    np.testing.assert_allclose(total / n_win, full, rtol=0, atol=1e-5)


def _assert_lists(got, want):
    """cnt equal and idx equal below it (the port pads with N up to cap)."""
    (gi, gc), (wi, wc) = got, want
    gi, gc, wi, wc = gi.numpy(), gc.numpy(), np.asarray(wi), np.asarray(wc)
    np.testing.assert_array_equal(gc, wc)
    for b in range(gc.shape[0]):
        for t in range(gc.shape[1]):
            np.testing.assert_array_equal(gi[b, t, :gc[b, t]], wi[b, t, :gc[b, t]])


@pytest.mark.parametrize("precision", ["exact-tight", "fast"])
@pytest.mark.parametrize("route", ["dense", "scatter"])
def test_slab_lists_match_jax(route, precision):
    """The lists of a slab's shifted boxes, equal as integers to JAX's: 4
    tiles (dense) and 256 tiles (128 rows of 8-row tiles at 2048 columns:
    the scatter route, K5's plain version, band-level corner cull under
    fast). The small splats wholly above or below the slab are in no list."""
    if route == "dense":
        hh, ww, y0, rows, th = H, W, 16, 32, 16
    else:
        hh, ww, y0, rows, th = 256, 2048, 64, 128, 8
    g9 = _g9(_genomes(seed=7, b=1, n=40, h=hh, w=ww))
    n_tx, n_ty = ww // 128, rows // th
    assert (n_tx * n_ty >= rc.SCATTER_TILES) == (route == "scatter")
    eps = 8e-2 if precision == "fast" else None
    t = tscreen.tier(precision, eps, True)
    corner_eps = t.corner_eps
    p = tscreen.screen(torch.from_numpy(g9), hh, ww, 3.0, t, y0)
    corner = None if corner_eps is None else rc._corner_params(p, corner_eps)
    got = rc.bin_splats(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, th, 128, 40, corner)

    pj = jcodec.preprocess(jnp.asarray(g9), hh, ww, 3.0)
    pj = pj._replace(cy=pj.cy - jnp.float32(y0), y0=pj.y0 - y0, y1=pj.y1 - y0)
    pj = rp._tighten_boxes(pj, 3.0, eps) if precision == "fast" else \
        jcodec.tighten_boxes_exact(pj, 3.0)
    cj = None if corner_eps is None else rp._corner_params(pj, corner_eps)
    want = rp._bin_splats(pj, n_tx, n_ty, th, 128, 40, interpret=True, corner=cj)
    _assert_lists(got, want)
    idx, cnt = got
    listed = {int(s) for s in idx[0][torch.arange(idx.shape[2])[None, :] < cnt[0][:, None]]}
    assert not listed & {0, 1, 2, 3}, "a splat outside the slab was binned"
