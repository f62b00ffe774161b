"""The port's scatter binning (ggs_tpu_torch/ops/render_cuda.py:
bin_splats_scatter, bin_splats' route, the rules, _band_lists,
_corner_band_xranges, and K5's plain version bin_splats_scatter_plain,
which K5's wrapper takes on CPU tensors) against ggs_tpu/ops/render_pallas.py's _bin_splats_scatter in
interpret mode, on the inputs of the JAX suite's own scatter tests
(tests/test_render_pallas.py:494-679). Both packages bin the same integer
boxes (JAX's codec) with the same corner parameters.

Tolerances: integers equal. cnt equal, and idx equal below cnt: the port
pads every list with N to its full width cap (equal to bin_splats_dense
entry for entry), where JAX writes only _SCATTER_PAD sentinels past cnt.
The entry-point case holds the fast canvas to CANVAS_ATOL = 4e-6, the fast
tier's cross-package tolerance (tests/test_torch_fast.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import codec as jcodec
from ggs_tpu.ops import render_pallas as rp
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.utils import profiling
from torch_inputs import axes_genomes, pass_lists
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

CANVAS_ATOL = 4e-6
BUDGET = rc.SCATTER_BUDGET


def _boxes(g, H, W, shift_rows=0):
    """JAX's preprocess boxes of axes genomes g, the rows shifted."""
    p = jcodec.preprocess(jcodec.genome_to_renderer(jnp.asarray(g)), H, W, 3.0)
    return p._replace(y0=p.y0 - shift_rows, y1=p.y1 - shift_rows)


def _coincident(N):
    """N identical splats at the canvas centre (test_render_pallas.py:603-608)."""
    return np.tile(np.array([[0.5, 0.5, np.log(4.0), np.log(4.0), 0.0, 128.0, 128.0, 128.0,
                              128.0]], np.float32), (1, N, 1))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _xy(p):
    return tuple(_t(getattr(p, f)) for f in ("x0", "x1", "y0", "y1"))


def _corner(p, eps):
    """JAX's corner parameters, and the same arrays for the port."""
    cj = rp._corner_params(p, eps)
    return cj, tuple(_t(c) for c in cj[:6]) + (cj[6],)


def _assert_lists(got, want, N):
    """cnt equal and idx equal below it; the port's pad is N up to cap."""
    (gi, gc), (wi, wc) = got, want
    gi, gc, wi, wc = gi.numpy(), gc.numpy(), np.asarray(wi), np.asarray(wc)
    np.testing.assert_array_equal(gc, wc)
    assert gi.shape == wi.shape
    slot = np.arange(gi.shape[2])[None, None, :]
    below = slot < gc[..., None]
    np.testing.assert_array_equal(np.where(below, gi, -1), np.where(below, wi, -1))
    assert (gi[~below] == N).all()


CASES = {
    # name: (seed, B, N, H, W, max_scale, n_tx, n_ty, cap, budget, shift_rows)
    "lossless": (0, 2, 40, 96, 256, 0.5, 2, 6, 40, BUDGET, 0),  # :494-521
    "truncating": (0, 2, 40, 96, 256, 0.5, 2, 6, 8, BUDGET, 0),
    "odd_tile_count": (1, 2, 30, 32, 384, 0.5, 3, 2, 30, BUDGET, 0),  # :523-545
    "negative_rows": (2, 1, 24, 64, 128, 0.5, 1, 2, 24, BUDGET, 32),  # :547-565
    "two_level": (3, 2, 64, 512, 128, 0.3, 1, 32, 64, 2048, 0),  # :568-589
    "budget_no_overflow": (4, 1, 40, 512, 128, 0.2, 1, 32, 40, 1152, 0),  # :620-635
}


@pytest.mark.parametrize("name", list(CASES))
def test_scatter_matches_jax(name, monkeypatch):
    """Without the corner cull: the port's lists against JAX's scatter
    lists, and entry for entry against bin_splats_dense (the rule the JAX
    tests pin for its scatter below cnt)."""
    seed, B, N, H, W, ms, n_tx, n_ty, cap, budget, shift = CASES[name]
    p = _boxes(axes_genomes(seed, B, N, H, W, ms), H, W, shift)
    want = rp._bin_splats_scatter(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, 16, 128, cap,
                                  interpret=True, smem_budget=budget)
    monkeypatch.setattr(rc, "SCATTER_BUDGET", budget)
    before = profiling.COUNTS["K5"]
    # the card's route (K5 wherever the rules plan it), in its plain version
    if rc.bin_route(B, n_tx, n_ty, cap, N, rc.SCATTER_PAD, None, "cuda") == "k5":
        got = rc.bin_splats_scatter(*_xy(p), n_tx, n_ty, 16, 128, cap)[:2]
    else:
        got = rc.bin_splats_dense(*_xy(p), n_tx, n_ty, 16, 128, cap)
    assert profiling.COUNTS["K5"] == before  # CPU tensors take the plain version
    _assert_lists(got, want, N)
    dense = rc.bin_splats_dense(*_xy(p), n_tx, n_ty, 16, 128, cap)
    np.testing.assert_array_equal(got[0].numpy(), dense[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), dense[1].numpy())
    if name == "budget_no_overflow":  # cap_s = 35 < cap, and no tile holds more
        plan = rc._scatter_plan(n_tx, n_ty, cap, N, rc.SCATTER_PAD, None)
        assert plan.cap_s == 35 and int(got[1].max()) <= 35


def test_scatter_overflow_falls_back_like_jax(monkeypatch):
    """96 coincident splats under a 2 KiB budget (cap_s = 63): the true
    count overflows, and both packages give the dense lists
    (test_render_pallas.py:592-618)."""
    N, H, W = 96, 512, 128
    p = _boxes(_coincident(N), H, W)
    want = rp._bin_splats_scatter(p.x0, p.x1, p.y0, p.y1, 1, 32, 16, 128, N, interpret=True,
                                  smem_budget=2048)
    monkeypatch.setattr(rc, "SCATTER_BUDGET", 2048)
    args = rc.scatter_args(*_xy(p), 1, 32, 16, 128, N)
    idx, cnt, tmax = rc.bin_splats_scatter_plain(**args)
    assert args["cap_s"] == 63 and int(tmax) == N > args["cap_s"]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want[1]))


def _band_case(coincident=0):
    """The band-cull case of test_render_pallas.py:639-679 (512x256, 32x128
    tiles, eps 8e-2, B=2, N=64), with `coincident` of candidate 0's splats
    moved onto one spot."""
    H, W, N, eps = 512, 256, 64, 8e-2
    g = axes_genomes(5, 2, N, H, W, 0.5)
    if coincident:
        g[0, :coincident] = _coincident(coincident)[0]
    p = rp._tighten_boxes(jcodec.preprocess(jcodec.genome_to_renderer(jnp.asarray(g)), H, W,
                                            3.0), 3.0, eps)
    return p, eps


def test_band_ranges_and_band_lists_match_jax():
    p, eps = _band_case()
    cj, ct = _corner(p, eps)
    n_ty = 16
    plan = rc._scatter_plan(2, n_ty, 64, 64, rc.SCATTER_PAD, ct)
    # rpg rises from 2 until rpg * n_tx % 8 == 0: 4 bands of 4 tile rows
    rpt = plan.rpg
    assert rpt == 4 and plan.two_level and plan.corner_x
    txl_j, txh_j = rp._corner_band_xranges(cj, p.x0, p.x1, p.y0, p.y1, rpt * 32, 128)
    txl_t, txh_t = rc._corner_band_xranges(ct, *_xy(p), rpt * 32, 128)
    np.testing.assert_array_equal(txl_t.numpy(), np.asarray(txl_j))
    np.testing.assert_array_equal(txh_t.numpy(), np.asarray(txh_j))
    empty = txh_t < txl_t
    assert empty.any() and (txh_t[empty] == txl_t[empty] - 1).all()
    keep = txl_t <= txh_t
    ty0, ty1 = _t(p.y0) // 32, _t(p.y1) // 32
    gl_j, gc_j = rp._band_lists_xla(jnp.asarray(ty0.numpy()), jnp.asarray(ty1.numpy()), n_ty, rpt,
                                    128, jnp.asarray(keep.numpy()))
    gl_t, gc_t = rc._band_lists(ty0, ty1, n_ty, rpt, 128, keep)
    np.testing.assert_array_equal(gl_t.numpy(), np.asarray(gl_j))
    np.testing.assert_array_equal(gc_t.numpy(), np.asarray(gc_j))


@pytest.mark.parametrize("coincident", [0, 40])
def test_band_cull_lists_match_jax(coincident, monkeypatch):
    """With the corner cull: the band-level lists (no overflow), and with
    40 coincident splats under a 1 KiB budget (cap_s = 31 < cap) the
    overflow fallback's per-tile corner lists, equal to JAX's. Without
    overflow: dense-corner lists within the band lists within the box
    lists, ascending, the band cull engaged."""
    p, eps = _band_case(coincident)
    cj, ct = _corner(p, eps)
    budget = 1024 if coincident else BUDGET
    want = rp._bin_splats_scatter(p.x0, p.x1, p.y0, p.y1, 2, 16, 32, 128, 64, interpret=True,
                                  smem_budget=budget, corner=cj)
    monkeypatch.setattr(rc, "SCATTER_BUDGET", budget)
    args = rc.scatter_args(*_xy(p), 2, 16, 32, 128, 64, corner=ct)
    idx, cnt, tmax = rc.bin_splats_scatter_plain(**args)
    _assert_lists((idx, cnt), want, 64)
    box = rc.bin_splats_dense(*_xy(p), 2, 16, 32, 128, 64)
    tile = rc.bin_splats_dense(*_xy(p), 2, 16, 32, 128, 64, corner=ct)
    if coincident:
        assert args["cap_s"] == 31 and int(tmax) > 31
        np.testing.assert_array_equal(idx.numpy(), tile[0].numpy())
        return
    assert int(cnt.sum()) < int(box[1].sum()) and int(tile[1].sum()) < int(cnt.sum())
    for b in range(2):
        for t in range(32):
            sc = idx[b, t, : int(cnt[b, t])].tolist()
            bx = set(box[0][b, t, : int(box[1][b, t])].tolist())
            dc = set(tile[0][b, t, : int(tile[1][b, t])].tolist())
            assert dc <= set(sc) <= bx and sc == sorted(sc), (b, t)


def _entry_case(seed, max_scale):
    """1024x512, N=48, 16x128 tiles (64 x 4 = 256 tiles: the scatter route)."""
    H, W, N = 1024, 512, 48
    g = axes_genomes(seed, 1, N, H, W, max_scale)
    return np.array(jcodec.genome_to_renderer(jnp.asarray(g))), H, W, N, 8e-2


def _fast_corner_renders(g9, H, W, eps):
    ref = rp.render_pallas(jnp.asarray(g9), H, W, tile_h=16, precision="fast", cull_eps=eps,
                           corner_cull=True, interpret=True, unroll=1)
    got = rc.render(torch.from_numpy(g9), H, W, tile_h=16, precision="fast", cull_eps=eps,
                    corner_cull=True)
    return got.numpy(), np.asarray(ref)


def test_fast_corner_entry_point_at_256_tiles():
    """render(precision="fast", corner_cull=True) at 256 tiles against
    render_pallas, and the port's lists against _bin_splats_xy. The
    band-level lists hold more pairs than the per-tile dense ones on these
    inputs, so a port that bins densely at 256 tiles fails here. Splats up
    to 0.05 of the canvas side keep the walks' own f32 gap inside the
    stated atol (larger ones: the test below)."""
    g9, H, W, N, eps = _entry_case(6, 0.05)
    got, ref = _fast_corner_renders(g9, H, W, eps)
    np.testing.assert_allclose(got, ref, atol=CANVAS_ATOL)

    cnt, idx, _, n_tx, n_ty = pass_lists(torch.from_numpy(g9), H, W, 3.0, "fast", None, 16, 128,
                                          eps, True)
    assert n_tx * n_ty == rc.SCATTER_TILES
    pj = rp._tighten_boxes(jcodec.preprocess(jnp.asarray(g9), H, W, 3.0), 3.0, eps)
    want = rp._bin_splats_xy(pj.x0, pj.x1, pj.y0, pj.y1, n_tx, n_ty, 16, 128, N,
                             interpret=True, corner=rp._corner_params(pj, eps))
    _assert_lists((idx, cnt), want, N)
    pt = rc._tighten_boxes(tcodec.preprocess(torch.from_numpy(g9), H, W, 3.0), 3.0, eps)
    _, tile_cnt = rc.bin_splats_dense(pt.x0, pt.x1, pt.y0, pt.y1, n_tx, n_ty, 16, 128, N,
                                      rc._corner_params(pt, eps))
    assert int(cnt.sum()) > int(tile_cnt.sum())


def _replay(table, ids, x, y, ch, fused):
    """One pixel's fast walk in float32 over a table [13, N+1] and a list:
    each product and sum rounded as written (the port's walk and walk.cu,
    built with -fmad=false; torch's exp2), or contracted into fused
    multiply-adds with XLA's exp2 (JAX's interpret-mode walk on the CPU)."""
    f32 = np.float32

    def fma(u, v, w):  # one rounding, as a fused multiply-add
        return f32(np.float64(u) * np.float64(v) + np.float64(w))

    c = f32(1.0)
    for s in ids:
        cx, cy, sxx, sxy, syy, r, g, bl, la, x0, x1, y0, y1 = table[:, s]
        if not (x > x0 and x < x1 and y > y0 and y < y1):
            continue
        col = (r, g, bl)[ch]
        qx, qy = f32(x) - cx, f32(y) - cy
        if fused:
            e = fma(sxx, qx * qx, fma(sxy, qx * qy, fma(syy, qy * qy, la)))
            c = fma(f32(jnp.exp2(e)), col - c, c)
        else:
            e = sxx * (qx * qx) + (sxy * (qx * qy) + (syy * (qy * qy) + la))
            c = c + f32(torch.exp2(torch.tensor(e)).item()) * (col - c)
    return np.clip(c, f32(0.0), f32(1.0))


def test_fast_canvas_gap_with_large_splats_is_xla_fma_contraction():
    """With splats up to 0.2 of the canvas side the two packages' fast
    canvases differ by more than CANVAS_ATOL on equal lists. A float32
    replay of the worst pixel over each package's own table pins the cause
    (as tests/test_torch_fast.py::test_fast_walk_gap_is_xla_fma_contraction
    does for small splats): the port's canvas equals the replay that rounds
    every operation bit for bit, JAX's the replay with fused multiply-adds
    within 3e-7 (about 1 ulp here: the replay's fma rounds through float64).
    The quadratic's terms grow with the offset from a large splat's centre
    and cancel, so the two roundings drift apart further than for small
    splats."""
    g9, H, W, N, eps = _entry_case(7, 0.2)
    got, ref = _fast_corner_renders(g9, H, W, eps)
    gap = np.abs(got - ref)
    b, y, x, ch = np.unravel_index(np.argmax(gap), gap.shape)
    assert gap[b, y, x, ch] > CANVAS_ATOL
    cnt, idx, feats, n_tx, n_ty = pass_lists(torch.from_numpy(g9), H, W, 3.0, "fast", None, 16,
                                             128, eps, True)
    pj = rp._tighten_boxes(jcodec.preprocess(jnp.asarray(g9), H, W, 3.0), 3.0, eps)
    ij, cj = rp._bin_splats_xy(pj.x0, pj.x1, pj.y0, pj.y1, n_tx, n_ty, 16, 128, N,
                               interpret=True, corner=rp._corner_params(pj, eps))
    t = (y // 16) * n_tx + x // 128
    ids = idx[b, t, : int(cnt[b, t])].tolist()
    assert ids == np.asarray(ij)[b, t, : int(np.asarray(cj)[b, t])].tolist()
    plain = _replay(feats[b].numpy(), ids, x, y, ch, fused=False)
    fused = _replay(np.asarray(rp._splat_feats_turbo(pj))[b], ids, x, y, ch, fused=True)
    assert got[b, y, x, ch] == plain
    np.testing.assert_allclose(ref[b, y, x, ch], fused, rtol=3e-7)


def test_max_bin_count_matches_jax():
    """The diagnostic through the dispatcher: dense at 8 tiles, scatter at
    256 (1024x512 at its 16x128 default). JAX's own max_bin_count runs its
    scatter compiled only, so at 256 tiles the count is held to the largest
    of JAX's dense counts, which its scatter equals without the cull."""
    for H, W in ((32, 512), (1024, 512)):
        g9 = np.array(jcodec.genome_to_renderer(jnp.asarray(axes_genomes(7, 2, 12, H, W, 1.0))))
        p = jcodec.preprocess(jnp.asarray(g9), H, W, 3.0)
        n_tx, n_ty = W // 128, H // 16
        _, cnt = rp._bin_splats_dense(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, 16, 128, 12)
        got = int(rc.max_bin_count(torch.from_numpy(g9), H, W))
        assert got == int(np.max(np.asarray(cnt)))
        if n_tx * n_ty < 256:
            assert got == int(rp.max_bin_count(jnp.asarray(g9), H, W))


# name: (n_tx, n_ty, pad_slots, budget, exact on the card, under the cull, exact on the CPU)
ROUTES = {
    "photo_24_tiles": (4, 6, rc.SCATTER_PAD, BUDGET, "k5", "dense", "dense"),
    "flagship_128_tiles": (8, 16, rc.SCATTER_PAD, BUDGET, "k5", "dense", "dense"),
    "grad_96_tiles": (4, 24, 40, BUDGET, "k5", "dense", "dense"),
    "tiles_256": (16, 16, rc.SCATTER_PAD, BUDGET, "k5", "k5", "k5"),
    "tiles_512": (16, 32, 40, BUDGET, "k5", "k5", "k5"),
    "no_plan_24_tiles": (4, 6, rc.SCATTER_PAD, 256, "dense", "dense", "dense"),
    "no_plan_256_tiles": (16, 16, rc.SCATTER_PAD, 256, "dense", "dense", "dense"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_bin_route_choice(name, monkeypatch):
    """bin_splats' route (render_cuda.bin_route) from what a call can see:
    exact lists go to K5 on the card wherever the scatter rules give a
    plan; under the corner cull the route stays JAX's (K5 from 256 tiles,
    dense below); CPU tensors keep the dense binning below 256 tiles; no
    plan, no K5. On CPU tensors bin_splats counts its call under that route,
    and where a plan exists its lists equal both routes': bin_splats_dense
    and K5's plain route (scatter_args, then bin_splats_scatter_plain)."""
    n_tx, n_ty, pad, budget, card, culled, cpu = ROUTES[name]
    monkeypatch.setattr(rc, "SCATTER_BUDGET", budget)
    B, N = 2, 40
    corner = (None,) * 7  # the rules read only whether a cull is given
    cuda = torch.device("cuda")  # a device object needs no card
    assert rc.bin_route(B, n_tx, n_ty, N, N, pad, None, cuda) == card
    assert rc.bin_route(B, n_tx, n_ty, N, N, pad, corner, cuda) == culled
    assert rc.bin_route(B, n_tx, n_ty, N, N, pad, corner, "cpu") == culled
    assert rc.bin_route(B, n_tx, n_ty, N, N, pad, None, "cpu") == cpu

    H, W = 16 * n_ty, 128 * n_tx
    boxes = _xy(_boxes(axes_genomes(9, B, N, H, W, 0.4), H, W))
    geo = (n_tx, n_ty, 16, 128, N)
    routes = ("bin.dense", "bin.k5")
    before = {k: profiling.COUNTS[k] for k in routes}
    got = rc.bin_splats(*boxes, *geo, pad_slots=pad)
    after = {k: profiling.COUNTS[k] - before[k] for k in routes}
    assert after == {k: int(k == "bin." + cpu) for k in routes}
    args = rc.scatter_args(*boxes, *geo, pad)
    assert (args is None) == (card == "dense")
    wants = [rc.bin_splats_dense(*boxes, *geo)]
    if args is not None:
        wants.append(rc.bin_splats_scatter_plain(**args)[:2])
    for want in wants:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,route", [(65535, "k5"), (65536, "dense")])
def test_bin_route_keeps_to_k5_launch_limits(B, route):
    """Exact lists below 256 tiles take K5 on the card only for batches its
    launch takes (csrc/scatter.cu geometry: B <= 65535), else the dense
    binning, which gives the same integers."""
    dev = torch.device("cuda")
    assert rc.bin_route(B, 8, 16, 5000, 5000, rc.SCATTER_PAD, None, dev) == route
