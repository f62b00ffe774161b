"""K5's stage order (ggs_tpu_torch/csrc/scatter.cu) replayed in plain
PyTorch, against the port's plain route (render_cuda.scatter_args then
bin_splats_scatter_plain) and ggs_tpu/ops/render_pallas.py's
_bin_splats_scatter in interpret mode.

The replay takes the band stage's row lists (render_cuda.
scatter_band_entries on CPU tensors: per band and chunk of 256 splats, the
ascending entries whose tile rows reach the band, each with its tile rows
and packed tile-column ranges, `_corner_band_xranges`' under the cull),
builds each tile's list from its band's entries in their order (the tile
stage: a warp appending the entries that pass the row and column tests),
and, where the band cull's largest true count exceeds cap_s, rebuilds the
lists from the same row lists by the box and the per-tile corner test (the
fallback). Cases: the band-cull case of tests/test_torch_scatter.py (512x256,
32x128 tiles), with and without 40 coincident splats that force the
overflow; the overflow with dead boxes (x0 = 1, x1 = -1) and splats the cull
drops from a whole band while they stay in its row list, where the fallback
must equal bin_splats_dense with the corner test; boxes reaching beyond the
canvas; and a grid of one row group, where the tile stage walks every splat.

Tolerances: integers equal. Against the plain route, idx over its whole
width, cnt and the largest true count; against JAX, cnt and idx below cnt
(JAX writes only _SCATTER_PAD sentinels past cnt). JAX's kernel clamps a
box's tile rows to its row group but walks its tile columns from tx0 on
without a clamp (render_pallas.py:812-860), so its lists are defined for
boxes whose columns lie on the canvas, as its codec's boxes do: boxes wider
than the canvas are held to the plain route, and without the cull to
bin_splats_dense, instead."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import codec as jcodec
from ggs_tpu.ops import render_pallas as rp
from ggs_tpu_torch.ops import render_cuda as rc
from torch_inputs import axes_genomes
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, N, EPS = 512, 256, 64, 8e-2  # the band case: 16 x 2 tiles of 32x128
TILE_H, TILE_W = 32, 128


def _t(x):
    return torch.from_numpy(np.array(x))


def _in_range(packed, v):
    return ((packed & 0xFFFF) <= v) & (v < (packed >> 16))


def _replay(boxes, corner, n_tx, n_ty, tile_h, tile_w, cap, pad_slots=rc.SCATTER_PAD):
    """K5's three stages in plain PyTorch: -> (idx, cnt, tmax, ent, ecnt, plan)."""
    x0, x1, y0, y1 = boxes
    B, n = x0.shape
    plan = rc._scatter_plan(n_tx, n_ty, cap, n, pad_slots, corner)
    cull = corner if plan.corner_x else None
    rpg = plan.rpg if plan.two_level else n_ty  # no bands: one list of every row's splats
    ent, ecnt = rc.scatter_band_entries(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, rpg, cull)
    nb, nc, chunk = ent.shape[1:4]
    # each band's row list: the chunks' entries in order
    valid = (torch.arange(chunk)[None, None, None, :] < ecnt[..., None]).reshape(B, nb, nc * chunk)
    ent = ent.reshape(B, nb, nc * chunk, 4)
    T = n_tx * n_ty
    t = torch.arange(T)
    tx, ty = t % n_tx, t // n_tx
    band = ty // rpg
    e, ok = ent[:, band], valid[:, band]  # [B, T, L, 4], [B, T, L]
    rows = _in_range(e[..., 1], (ty - band * rpg)[None, :, None])

    def lists(keep):
        """Each tile's kept entries in entry order (a warp's ordered append)."""
        pos = torch.sort((~keep).to(torch.int8), dim=-1, stable=True).indices
        s = torch.gather(e[..., 0], 2, pos)
        count = keep.sum(-1, dtype=torch.int32)
        slot = torch.arange(s.shape[2])[None, None, :]
        s = torch.where(slot < count[..., None], s, n)
        pad = torch.full((B, T, max(cap - s.shape[2], 0)), n, dtype=torch.int32)
        return torch.cat([s, pad], 2)[..., :cap], count

    keep = ok & rows & _in_range(e[..., 2], tx[None, :, None])
    idx, true = lists(keep)
    tmax = true.max()
    if cull is not None and plan.cap_s < cap and int(tmax) > plan.cap_s:
        s = e[..., 0].reshape(B, -1).long()
        L = e.shape[2]
        par = [torch.gather(c, 1, s) for c in (*boxes, *corner[:6])]
        tile = lambda v: v.repeat_interleave(L)[None, None, :]  # noqa: E731
        corner_ok = rc._corner_keep((*par[4:], corner[6]), *par[:4], tile(tx), tile(ty), tile_h,
                                    tile_w).reshape(B, T, L)
        keep = ok & rows & _in_range(e[..., 3], tx[None, :, None]) & corner_ok
        idx, count = lists(keep)
        return idx, count.clamp_max(cap), tmax, ent, valid, plan
    return idx, true.clamp_max(cap), tmax, ent, valid, plan


def _jax_boxes(g, dead=(), widen=None):
    """JAX's eps-tight boxes of axes genomes g; `dead` splats of candidate 0
    get alpha below eps (the box x0 = 1, x1 = -1); `widen` (dx, dy) pushes
    every box that far past its edges, beyond the canvas."""
    g = g.copy()
    for s in dead:
        g[0, s, 8] = 10.0  # 10 / 255 < eps
    p = rp._tighten_boxes(jcodec.preprocess(jcodec.genome_to_renderer(jnp.asarray(g)), H, W, 3.0),
                          3.0, EPS)
    if widen is not None:
        dx, dy = widen
        p = p._replace(x0=p.x0 - dx, x1=p.x1 + dx, y0=p.y0 - dy, y1=p.y1 + dy)
    return p


def _band_genomes(coincident=0):
    g = axes_genomes(5, 2, N, H, W, 0.5)
    if coincident:
        g[0, :coincident] = np.array([0.5, 0.5, np.log(4.0), np.log(4.0), 0.0, 128.0, 128.0,
                                      128.0, 128.0], np.float32)
    return g


CASES = {
    # name: (genome args, dead splats, widen, budget, corner cull, n_ty)
    "band_cull": (0, (), None, rc.SCATTER_BUDGET, True, 16),
    "band_cull_overflow": (40, (), None, 1024, True, 16),
    "overflow_dead_boxes": (40, (44, 45, 50, 61), None, 1024, True, 16),
    "rows_beyond_canvas": (0, (), (0, 90), rc.SCATTER_BUDGET, True, 16),
    "wider_than_canvas": (0, (), (300, 90), rc.SCATTER_BUDGET, True, 16),
    "no_cull_wider_than_canvas": (0, (), (300, 90), rc.SCATTER_BUDGET, False, 16),
    "one_row_group": (0, (), (0, 20), rc.SCATTER_BUDGET, True, 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stage_replay_matches_plain_route_and_jax(name, monkeypatch):
    coincident, dead, widen, budget, cull, n_ty = CASES[name]
    p = _jax_boxes(_band_genomes(coincident), dead, widen)
    cj = rp._corner_params(p, EPS) if cull else None
    ct = None if cj is None else tuple(_t(c) for c in cj[:6]) + (cj[6],)
    boxes = tuple(_t(getattr(p, f)) for f in ("x0", "x1", "y0", "y1"))
    h = n_ty * TILE_H
    on_canvas = widen is None or widen[0] == 0  # JAX's lists are defined
    if on_canvas:
        want = rp._bin_splats_scatter(p.x0, p.x1, p.y0, p.y1, 2, n_ty, TILE_H, TILE_W, N,
                                      interpret=True, smem_budget=budget, corner=cj)
    monkeypatch.setattr(rc, "SCATTER_BUDGET", budget)
    idx, cnt, tmax, ent, valid, plan = _replay(boxes, ct, 2, n_ty, TILE_H, TILE_W, N)
    args = rc.scatter_args(*boxes, 2, n_ty, TILE_H, TILE_W, N, corner=ct)
    pi, pc, pt = rc.bin_splats_scatter_plain(**args)
    assert torch.equal(idx, pi) and torch.equal(cnt, pc) and int(tmax) == int(pt)
    # and the wrapper on CPU tensors takes that route
    got = rc.bin_splats_scatter(*boxes, 2, n_ty, TILE_H, TILE_W, N, corner=ct)
    assert all(torch.equal(a, b) for a, b in zip(got, (pi, pc, pt)))

    if on_canvas:
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want[1]))
        below = np.arange(N)[None, None, :] < cnt.numpy()[..., None]
        np.testing.assert_array_equal(np.where(below, idx.numpy(), -1),
                                      np.where(below, np.asarray(want[0]), -1))
    if not cull:
        dense = rc.bin_splats_dense(*boxes, 2, n_ty, TILE_H, TILE_W, N)
        assert torch.equal(idx, dense[0]) and torch.equal(cnt, dense[1])

    overflow = plan.corner_x and plan.cap_s < N and int(tmax) > plan.cap_s
    assert overflow == (coincident > 0)
    assert plan.two_level == (n_ty > 2) and plan.corner_x == (cull and n_ty > 2)
    if overflow:  # the fallback over the row lists is the dense per-tile corner binning
        dense = rc.bin_splats_dense(*boxes, 2, n_ty, TILE_H, TILE_W, N, ct)
        assert torch.equal(idx, dense[0]) and torch.equal(cnt, dense[1])
    if plan.corner_x:
        # the row lists keep the splats the cull drops from a whole band
        in_list = valid & (ent[..., 1] >> 16 > (ent[..., 1] & 0xFFFF))
        culled = in_list & ((ent[..., 2] >> 16) <= (ent[..., 2] & 0xFFFF))
        assert int(culled.sum()) > 0 and int(in_list.sum()) > int(culled.sum())
    if dead:
        assert (boxes[0][0, list(dead)] == 1).all() and (boxes[1][0, list(dead)] == -1).all()
    if widen is not None:
        assert int(boxes[2].min()) < 0 and int(boxes[3].max()) >= h
        assert on_canvas or (int(boxes[0].min()) < 0 and int(boxes[1].max()) >= W)


def test_band_entries_hold_the_band_ranges():
    """The band stage's packed columns are `_corner_band_xranges`' [txl, txh]
    clamped to the grid, for every splat its band's row list holds, and the
    row lists hold exactly `_band_lists`' splats before its cull filter."""
    p = _jax_boxes(_band_genomes(), (3, 9), (120, 40))
    cj = rp._corner_params(p, EPS)
    ct = tuple(_t(c) for c in cj[:6]) + (cj[6],)
    boxes = tuple(_t(getattr(p, f)) for f in ("x0", "x1", "y0", "y1"))
    plan = rc._scatter_plan(2, 16, N, N, rc.SCATTER_PAD, ct)
    ent, ecnt = rc.scatter_band_entries(*boxes, 2, 16, TILE_H, TILE_W, plan.rpg, ct)
    txl, txh = rc._corner_band_xranges(ct, *boxes, plan.rpg * TILE_H, TILE_W)
    gl, gcnt = rc._band_lists(boxes[2] // TILE_H, boxes[3] // TILE_H, 16, plan.rpg, N)
    for b in range(2):
        for k in range(ent.shape[1]):
            e = torch.cat([ent[b, k, c, : int(ecnt[b, k, c])] for c in range(ent.shape[2])])
            s = e[:, 0].long()
            assert s.tolist() == gl[b, k, : int(gcnt[b, k, 0])].tolist()
            want = rc._pack_range(txl[b, k, s], txh[b, k, s], 2)
            assert torch.equal(e[:, 2], want)
