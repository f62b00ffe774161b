"""The port's fast and bf16 tiers (ggs_tpu_torch/ops/render_cuda.py: the
eps-tight boxes, the corner cull, K4's table builder, the K3 exp2 walk and
the K1-bf16 walk, through render/fitness/render_splats) against the JAX
package on the same float32 inputs, on the CPU: the port's wrappers take
their plain versions there, and the JAX side runs its Pallas kernels in
interpret mode, as its own tests do.

Tolerances, with their sources:
* boxes, corner-cull decisions, lists and counts: equal;
* K4's table: within 4 ulp (rtol 5e-7), its -inf entries and sentinel
  column equal (XLA's and PyTorch's CPU exp/log differ by 1-2 ulp);
* fast canvas across packages: CANVAS_ATOL = 4e-6, the port's exact-tier
  cross-package tolerance (tests/test_torch_render.py), on the inputs the
  exact-tier test uses (seed 2: measured 2.1e-6). On seeds 0-3 of the same
  shape the fast gap reaches 7.4e-6 where the exact gap is 3.1e-6: the
  codec's 1-2 ulp exp differences in the precision entries, amplified by
  the quadratic (ROADMAP.md section 3), and, fed the same screen-space
  parameters and lists, 7.5e-6 on seed 0 because JAX's interpret-mode walk
  on the CPU contracts its products and sums into fused multiply-adds,
  where the port (and walk.cu, built with -fmad=false) rounds each one
  (test_fast_walk_gap_is_xla_fma_contraction replays the pixel both ways);
  XLA's CPU exp2 is also looser than torch's (pinned below);
* fast fitness across packages: rtol 5e-5 (tests/test_render_pallas.py:140);
* fast against exact: the JAX suite's own bounds, canvas atol 4e-3,
  fitness rtol 1e-3 with the same ranking (tests/test_render_pallas.py:204-
  214), and max 2e-2 / mean 2e-4 on the culled 256x256 case (:253-254);
* bf16 fitness: rtol BF16_RTOL = 1e-5 against the JAX package's bf16
  (measured worst 2.4e-7 on seeds 0-1 below), and rtol 2e-2 against each
  package's own "highest" (measured worst 2.0e-3 and 3.2e-3 on seeds 0 and
  1), from which it must also differ by more than 10 x BF16_RTOL, so that a
  walk skipping the bf16 roundings cannot pass."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import codec as jcodec
from ggs_tpu.ops import render_pallas as rp
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import oracle as toracle
from ggs_tpu_torch.ops import render as trender
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.utils import profiling
from torch_inputs import axes_genomes, image, pass_lists, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, TH, TW = 40, 200, 16, 128
CANVAS_ATOL = 4e-6
BF16_RTOL = 1e-5


def _g9(seed, B=3, N=16, H=H, W=W, max_scale=0.3, alphas=None):
    """Renderer genomes (JAX's codec); `alphas` overrides the first
    splats' 0-255 alpha genes of candidate 0."""
    g = axes_genomes(seed, B, N, H, W, max_scale)
    if alphas is not None:
        g[0, : len(alphas), 8] = alphas
    return np.array(jcodec.genome_to_renderer(jnp.asarray(g)))


# alpha 0; alpha 0.3/255 and 0.5/255, below eps = 2e-3; alpha 20/255, below 8e-2
EDGE_ALPHAS = (0.0, 0.3, 0.5, 20.0)


def _screens(g9, eps, Hc=H, Wc=W):
    pj = rp._tighten_boxes(jcodec.preprocess(jnp.asarray(g9), Hc, Wc, 3.0), 3.0, eps)
    pt = rc._tighten_boxes(tcodec.preprocess(torch.from_numpy(g9), Hc, Wc, 3.0), 3.0, eps)
    return pj, pt


@pytest.mark.parametrize("cap", [24, 5])
@pytest.mark.parametrize("eps", [2e-3, 8e-2])
@pytest.mark.parametrize("Hc,Wc", [(40, 200), (75, 131)])
def test_boxes_corner_cull_and_lists_match(Hc, Wc, eps, cap):
    """_tighten_boxes, _corner_keep and bin_splats_dense(corner=...) against
    the JAX package's: boxes, keep decisions, lists and counts equal."""
    g9 = _g9(7, B=3, N=24, H=Hc, W=Wc, max_scale=1.0, alphas=EDGE_ALPHAS)
    pj, pt = _screens(g9, eps, Hc, Wc)
    for f in ("x0", "x1", "y0", "y1"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), err_msg=f)
    n_tx, n_ty = -(-Wc // TW), -(-Hc // TH)
    t = np.arange(n_tx * n_ty, dtype=np.int32)
    tx, ty = (t % n_tx)[None, :, None], (t // n_tx)[None, :, None]
    cj, ct = rp._corner_params(pj, eps), rc._corner_params(pt, eps)
    keep_j = rp._corner_keep(cj, pj.x0, pj.x1, pj.y0, pj.y1, jnp.asarray(tx), jnp.asarray(ty), TH, TW)
    keep_t = rc._corner_keep(ct, pt.x0, pt.x1, pt.y0, pt.y1, torch.from_numpy(tx),
                             torch.from_numpy(ty), TH, TW)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    ij, cntj = rp._bin_splats_dense(pj.x0, pj.x1, pj.y0, pj.y1, n_tx, n_ty, TH, TW, cap, corner=cj)
    it, cntt = rc.bin_splats_dense(pt.x0, pt.x1, pt.y0, pt.y1, n_tx, n_ty, TH, TW, cap, corner=ct)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(cntt.numpy(), np.asarray(cntj))
    # the cull engaged, and the sub-eps splats of candidate 0 are in no list
    _, cnt_box = rc.bin_splats_dense(pt.x0, pt.x1, pt.y0, pt.y1, n_tx, n_ty, TH, TW, 24)
    _, cnt_all = rc.bin_splats_dense(pt.x0, pt.x1, pt.y0, pt.y1, n_tx, n_ty, TH, TW, 24, ct)
    assert int(cnt_all.sum()) < int(cnt_box.sum())
    dead = [i for i, a in enumerate(EDGE_ALPHAS) if a / 255.0 <= eps]
    listed = it[0][torch.arange(cap)[None, :] < cntt[0][:, None]]
    assert not set(dead) & set(listed.tolist())


@pytest.mark.parametrize("eps", [None, 8e-2])
@pytest.mark.parametrize("Hc,Wc,seed", [(40, 200, 8), (75, 131, 9)])
def test_prep_fast_matches_prep_turbo(Hc, Wc, seed, eps):
    """K4's plain version against _prep_turbo_pallas (interpret mode): fi
    equal, ff within 4 ulp with its -inf entries and sentinel column equal,
    and the fitness route's corner-culled lists equal."""
    g9 = _g9(seed, B=3, N=24, H=Hc, W=Wc, max_scale=1.0, alphas=EDGE_ALPHAS)
    ffj, fij = (np.asarray(x) for x in rp._prep_turbo_pallas(jnp.asarray(g9), Hc, Wc, 3.0, True, eps))
    fft, fit = rc.prep_fast_plain(torch.from_numpy(g9), Hc, Wc, 3.0, eps)
    assert fft.shape == (3, 13, 25) and fit.dtype == torch.int32 and fit.shape == (3, 4, 24)
    np.testing.assert_array_equal(fit.numpy(), fij)
    fft = fft.numpy()
    np.testing.assert_array_equal(fft[:, :, 24], ffj[:, :, 24])
    np.testing.assert_array_equal(np.isneginf(fft), np.isneginf(ffj))
    assert np.isneginf(fft[0, 8, 0]) and np.isfinite(fft[:, 2:5]).all()
    fin = np.isfinite(ffj)
    np.testing.assert_allclose(fft[fin], ffj[fin], rtol=5e-7, atol=0)
    # the fitness route's lists: boxes from fi, corner parameters from ff's rows
    n_tx, n_ty = -(-Wc // TW), -(-Hc // TH)
    e = rc._eps(eps)
    cj = tuple(jnp.asarray(ffj[:, r, :24]) for r in (0, 1, 2, 3, 4, 8)) + (np.log2(e),)
    ij, cntj = rp._bin_splats_dense(*(jnp.asarray(fij[:, i]) for i in range(4)), n_tx, n_ty, TH,
                                    TW, 24, corner=cj)
    cnt, idx, ff, _, _ = pass_lists(torch.from_numpy(g9), Hc, Wc, 3.0, "fast", None, TH, TW,
                                     eps, True, fitness_route=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cntj))
    np.testing.assert_array_equal(ff.numpy(), fft)


@pytest.mark.parametrize("corner", [False, True])
@pytest.mark.parametrize("Hc,Wc,eps", [(H, W, None), (75, 131, 8e-2)])
def test_fast_render_matches_render_pallas(Hc, Wc, eps, corner):
    """K3's canvas through render(precision="fast") against render_pallas."""
    g9 = _g9(2, B=3, N=16, H=Hc, W=Wc)
    ref = rp.render_pallas(jnp.asarray(g9), Hc, Wc, tile_h=TH, tile_w=TW, precision="fast",
                           cull_eps=eps, corner_cull=corner, interpret=True)
    got = rc.render(torch.from_numpy(g9), Hc, Wc, tile_h=TH, tile_w=TW, precision="fast",
                    cull_eps=eps, corner_cull=corner)
    assert got.shape == (3, Hc, Wc, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=CANVAS_ATOL)


def test_fast_walk_gap_is_xla_fma_contraction():
    """Where the fast canvases differ most (seed 0, 7.5e-6), with both walks
    fed the same screen-space parameters and equal lists, a float32 replay
    of the pixel pins the cause: the port's walk rounds every product and
    sum as written (as walk.cu does, built with -fmad=false), while JAX's
    interpret-mode walk on the CPU contracts them into fused multiply-adds."""
    g9 = _g9(0, B=3, N=16)
    p = rc._tighten_boxes(tcodec.preprocess(torch.from_numpy(g9), H, W, 3.0), 3.0, 8e-2)
    pj = jcodec.SplatScreen(*(jnp.asarray(x.numpy()) for x in p))
    ref = np.asarray(rp._render_padded(pj, H, W, TH, TW, (1.0, 1.0, 1.0), 8, True,
                                       precision="fast", corner_eps=8e-2))
    n_tx, n_ty = -(-W // TW), -(-H // TH)
    idx, cnt = rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, TH, TW, 16,
                                   rc._corner_params(p, 8e-2))
    ij, cj = rp._bin_splats_dense(pj.x0, pj.x1, pj.y0, pj.y1, n_tx, n_ty, TH, TW, 16,
                                  corner=rp._corner_params(pj, 8e-2))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    got = rc.render_tiles_fast(cnt, idx, rc._splat_feats_turbo(p), n_tx, TH, TW,
                               (1.0, 1.0, 1.0)).numpy()
    gap = np.abs(got - ref)
    b, ch, y, x = np.unravel_index(np.argmax(gap), gap.shape)
    assert gap[b, ch, y, x] > CANVAS_ATOL
    table = np.asarray(rp._splat_feats_turbo(pj))
    f32 = np.float32

    def fma(u, v, w):  # one rounding, as a fused multiply-add
        return f32(np.float64(u) * np.float64(v) + np.float64(w))

    t = (y // TH) * n_tx + x // TW
    plain = fused = f32(1.0)
    for s in idx[b, t, : int(cnt[b, t])].tolist():
        cx, cy, sxx, sxy, syy, r, g, bl, la, x0, x1, y0, y1 = table[b, :, s]
        if not (x > x0 and x < x1 and y > y0 and y < y1):
            continue
        col = (r, g, bl)[ch]
        qx, qy = f32(x) - cx, f32(y) - cy
        e = sxx * (qx * qx) + (sxy * (qx * qy) + (syy * (qy * qy) + la))
        plain = plain + f32(jnp.exp2(e)) * (col - plain)
        e = fma(sxx, qx * qx, fma(sxy, qx * qy, fma(syy, qy * qy, la)))
        fused = fma(f32(jnp.exp2(e)), col - fused, fused)
    np.testing.assert_allclose(got[b, ch, y, x], plain, rtol=3e-7)
    np.testing.assert_allclose(ref[b, ch, y, x], fused, rtol=3e-7)


def test_xla_exp2_is_looser_than_torch():
    """Why the fast canvas gap can exceed the exact one on some inputs: on
    the CPU XLA's exp2 is up to ~17 ulp off over the walk's exponents, where
    torch.exp2 (and CUDA's exp2f) stay within 1-2 ulp."""
    x = np.linspace(-40.0, 0.0, 20001).astype(np.float32)
    ref = np.exp2(x.astype(np.float64))
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    err_t = np.abs(torch.exp2(torch.from_numpy(x)).numpy() - ref) / ulp
    err_j = np.abs(np.asarray(jnp.exp2(jnp.asarray(x)), np.float64) - ref) / ulp
    assert err_t.max() <= 1.0 and err_j.max() > 4.0


@pytest.mark.parametrize("corner", [False, True])
@pytest.mark.parametrize("mode", ["plain", "weighted", "boost"])
def test_fast_fitness_matches_fitness_pallas(mode, corner):
    """K4 -> corner-culled dense lists -> K3 fitness, against
    fitness_pallas(precision="fast") in all three scoring modes."""
    g9 = _g9(3, B=3, N=16, alphas=EDGE_ALPHAS)
    tgt = image(3, H, W)
    wm = None if mode == "plain" else weights(3, H, W)
    boost = mode == "boost"
    kw = dict(boost_only=boost, boost_beta=0.8, tile_h=TH, tile_w=TW, precision="fast",
              cull_eps=8e-2, corner_cull=corner)
    ref = rp.fitness_pallas(jnp.asarray(g9), jnp.asarray(tgt),
                            None if wm is None else jnp.asarray(wm), H, W, interpret=True, **kw)
    got = rc.fitness(torch.from_numpy(g9), torch.from_numpy(tgt),
                     None if wm is None else torch.from_numpy(wm), H, W, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5)


def test_fast_close_to_exact():
    """The JAX suite's fast-vs-exact bounds (tests/test_render_pallas.py:
    190-214) on the port alone: canvas within 4e-3 of the exact render,
    fitness within rtol 1e-3 with the same ranking."""
    g9 = torch.from_numpy(_g9(4, B=3, N=24))
    ref = toracle.render_dense(g9, H, W)
    got = rc.render(g9, H, W, tile_h=TH, precision="fast")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=4e-3)
    tgt = torch.from_numpy(image(4, H, W))
    f_exact = rc.fitness(g9, tgt, None, H, W, tile_h=TH)
    f_fast = rc.fitness(g9, tgt, None, H, W, tile_h=TH, precision="fast")
    np.testing.assert_allclose(f_fast.numpy(), f_exact.numpy(), rtol=1e-3)
    assert (np.argsort(f_fast.numpy()) == np.argsort(f_exact.numpy())).all()


def test_fast_cull_on_256_canvas():
    """tests/test_render_pallas.py:218-254 on the port: live tight boxes only
    shrink, dead splats get the empty box and are in no list, the pairs
    fall, and the culled fast render is within max 2e-2 / mean 2e-4 of the
    exact one."""
    Hc = Wc = 256
    g = axes_genomes(11, 4, 96, Hc, Wc, 0.4)
    g[:, ::7, 8] = 0.0  # some invisible splats
    g9 = tcodec.genome_to_renderer(torch.from_numpy(g))
    p = tcodec.preprocess(g9, Hc, Wc, 3.0)
    pt = rc._tighten_boxes(p, 3.0)
    live = p.a.numpy() > 0.0
    for tight, cons, cmp in ((pt.x0, p.x0, np.greater_equal), (pt.x1, p.x1, np.less_equal),
                             (pt.y0, p.y0, np.greater_equal), (pt.y1, p.y1, np.less_equal)):
        assert cmp(tight.numpy(), cons.numpy())[live].all()
    assert (pt.x0.numpy() > pt.x1.numpy())[~live].all()
    n_tx, n_ty = -(-Wc // 128), -(-Hc // 32)
    _, c0 = rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, 32, 128, 96)
    idx1, c1 = rc.bin_splats_dense(pt.x0, pt.x1, pt.y0, pt.y1, n_tx, n_ty, 32, 128, 96)
    assert int(c1.sum()) < int(c0.sum())
    listed = set(np.unique(idx1[0].numpy())[:-1].tolist())  # drop the sentinel
    assert not set(np.flatnonzero(g[0, :, 8] == 0.0).tolist()) & listed
    ref = toracle.render_dense(g9, Hc, Wc)
    got = rc.render(g9, Hc, Wc, tile_h=32, precision="fast")
    dev = (got - ref).abs()
    assert float(dev.max()) <= 2e-2 and float(dev.mean()) < 2e-4


def test_alpha_zero_and_sub_eps_splats():
    """tests/test_render_pallas.py:481-491: alpha-0 splats contribute
    exactly nothing under the fast walk (log2a = -inf, exp2(-inf) = 0, and
    the cull drops them); sub-eps splats are in no list of either route."""
    g9 = _g9(5, B=1, N=6, H=32, W=128)
    g9[:, ::2, 8] = 0.0
    t = torch.from_numpy(g9)
    got = rc.render(t, 32, 128, precision="fast")
    np.testing.assert_allclose(got.numpy(), rc.render(t, 32, 128).numpy(), atol=4e-3)
    only_live = rc.render(t[:, 1::2], 32, 128, precision="fast")
    np.testing.assert_allclose(got.numpy(), only_live.numpy(), atol=1e-6)
    # the turbo table's -inf alpha rows walk as exact no-ops, listed or not
    p = tcodec.preprocess(t, 32, 128, 3.0)
    idx, cnt = rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, 1, 1, 32, 128, 6)
    alone = rc.render_tiles_fast(cnt, idx, rc._splat_feats_turbo(p), 1, 32, 128, (1.0, 1.0, 1.0))
    p_live = tcodec.preprocess(t[:, 1::2], 32, 128, 3.0)
    idx2, cnt2 = rc.bin_splats_dense(p_live.x0, p_live.x1, p_live.y0, p_live.y1, 1, 1, 32, 128, 3)
    live = rc.render_tiles_fast(cnt2, idx2, rc._splat_feats_turbo(p_live), 1, 32, 128,
                                (1.0, 1.0, 1.0))
    np.testing.assert_array_equal(alone.numpy(), live.numpy())
    # sub-eps splats: in no list of the render route nor of K4's
    g9 = torch.from_numpy(_g9(6, B=2, N=12, alphas=EDGE_ALPHAS))
    for route in (False, True):
        cnt, idx, _, _, _ = pass_lists(g9, H, W, 3.0, "fast", None, TH, TW, 8e-2, True,
                                        fitness_route=route)
        listed = idx[0][torch.arange(12)[None, :] < cnt[0][:, None]]
        assert not {0, 1, 2, 3} & set(listed.tolist())


@pytest.mark.parametrize("seed,mode", [(0, "weighted"), (1, "plain")])
def test_bf16_fitness_matches(seed, mode):
    """K1-bf16's plain version through fitness(precision="bf16") against
    fitness_pallas(precision="bf16"), and each against its own "highest"."""
    g9 = _g9(seed, B=3, N=16, max_scale=0.5)
    tgt = image(seed, H, W)
    wm = None if mode == "plain" else weights(seed, H, W)
    wj = None if wm is None else jnp.asarray(wm)
    wt = None if wm is None else torch.from_numpy(wm)
    ref = {p: np.asarray(rp.fitness_pallas(jnp.asarray(g9), jnp.asarray(tgt), wj, H, W, tile_h=TH,
                                           precision=p, interpret=True))
           for p in ("bf16", "highest")}
    got = {p: rc.fitness(torch.from_numpy(g9), torch.from_numpy(tgt), wt, H, W, tile_h=TH,
                         precision=p).numpy()
           for p in ("bf16", "highest")}
    np.testing.assert_allclose(got["bf16"], ref["bf16"], rtol=BF16_RTOL)
    for f in (got, ref):
        np.testing.assert_allclose(f["bf16"], f["highest"], rtol=2e-2)
        # the bf16 walk ran: its roundings show far above BF16_RTOL
        assert np.max(np.abs(f["bf16"] / f["highest"] - 1.0)) > 10 * BF16_RTOL


def test_fast_epilogues_agree_and_cpu_takes_plain():
    """K3's fitness partials equal the weighted SSE of K3's canvas over each
    tile, K1-bf16's partials that of the bf16 walk's canvas; on CPU tensors
    no K3/K4/K1-bf16 wrapper counts a launch."""
    g9 = torch.from_numpy(_g9(4, B=2, N=20))
    keys = ("K3", "K3-canvas", "K1-bf16", "K4")
    before = [profiling.COUNTS[k] for k in keys]
    cnt, idx, ff, n_tx, n_ty = pass_lists(g9, H, W, 3.0, "fast", None, TH, TW, None, True,
                                           fitness_route=True)
    Hp, Wp = n_ty * TH, n_tx * TW
    tgt_p, w_p = rc.pad_planes(torch.from_numpy(image(4, H, W)), torch.from_numpy(weights(4, H, W)),
                               Hp, Wp)
    bg = (1.0, 1.0, 1.0)

    def per_tile(canvas):
        sse = ((canvas - tgt_p[None]) ** 2).sum(1) * w_p[None]
        return sse.reshape(2, n_ty, TH, n_tx, TW).sum((2, 4)).reshape(2, -1)

    canvas = rc.render_tiles_fast(cnt, idx, ff, n_tx, TH, TW, bg)
    partials = rc.fitness_tiles_fast(cnt, idx, ff, tgt_p, w_p, n_tx, TH, TW, bg)
    np.testing.assert_allclose(partials.numpy(), per_tile(canvas).numpy(), rtol=1e-5)
    cnt, idx, feats, _, _ = pass_lists(g9, H, W, 3.0, "bf16", None, TH, TW)
    canvas = torch.stack(rc._walk_plain(cnt, idx, feats, n_tx, TH, TW, bg, "bf16"), 1)
    canvas = canvas.reshape(2, 3, n_ty, n_tx, TH, TW).transpose(3, 4).reshape(2, 3, Hp, Wp)
    partials = rc.fitness_tiles_bf16(cnt, idx, feats, tgt_p, w_p, n_tx, TH, TW, bg)
    np.testing.assert_allclose(partials.numpy(), per_tile(canvas).numpy(), rtol=1e-5)
    assert [profiling.COUNTS[k] for k in keys] == before


def test_render_splats_fast_and_bf16():
    """The front door: "fast" walks K3 in the cuda backend and renders exact
    in the oracle, "bf16" renders as "highest" in both; unknown tiers are
    refused."""
    g9 = torch.from_numpy(_g9(5, B=2, N=12))
    exact = trender.render_splats(g9, H, W, impl="oracle")
    for impl in ("oracle", "cuda"):
        bf = trender.render_splats(g9, H, W, impl=impl, tile_h=TH, precision="bf16")
        np.testing.assert_array_equal(bf.numpy(), exact.numpy())
    np.testing.assert_array_equal(
        trender.render_splats(g9, H, W, impl="oracle", precision="fast", cull_eps=8e-2).numpy(),
        exact.numpy(),
    )
    fast = trender.render_splats(g9, H, W, impl="cuda", tile_h=TH, precision="fast",
                                 cull_eps=8e-2, corner_cull=True)
    want = rc.render(g9, H, W, tile_h=TH, precision="fast", cull_eps=8e-2, corner_cull=True)
    np.testing.assert_array_equal(fast.numpy(), want.numpy())
    assert not np.array_equal(fast.numpy(), exact.numpy())
    with pytest.raises(ValueError):
        trender.render_splats(g9, H, W, precision="half")
