"""The order in which the forward walk kernels (csrc/walk.cu: K1, K2, K3 and
K1-bf16) walk a list tile, replayed in plain PyTorch on the CPU against the
plain versions (render_cuda._walk_plain, fitness_tiles_plain):

* a block walks a sub-tile of 4 rows x 128 columns, and every sub-tile of a
  tile walks the tile's whole list, from the background or the init canvas
  (rounded to bf16 in mode 2);
* a listed splat whose rows miss the sub-tile's four is skipped (dropped
  while it is staged, by a ballot that keeps the list's order), and so is
  one whose columns miss a warp's 32 (a warp-uniform test);
* a kept splat's row terms (qy and the quadratic's qy^2 part, with log2a
  in mode 1; bf16 pairs in mode 2) are computed once per sub-tile while it
  is staged, and each pixel reads them;
* the four rows then blend on one of three paths: where the box holds the
  sub-tile's rows and the warp's columns, f = e with no select; where it
  holds the rows only, a select on the column; elsewhere each pixel outside
  the box takes f = 0 by a select, which must leave it unchanged bit for
  bit ((1-0) C + 0 c == C, C + 0 (c - C) == C);
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
tiles 8-64 rows high on an odd canvas. Hand-placed boxes put each path to
work: boxes that hold whole sub-tiles and warps, boxes that hold the rows
only, boxes that straddle both, and a thin, long splat whose quadratic
turns positive beside its box column, so that exp overflows there and
only the select keeps those pixels. `render_cuda.walk_path_counts`, the
count of visits by path, is held to a brute-force count on the same
lists."""
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
    [B, T, S, 4, 128]: the row terms computed once per (splat, sub-tile) as
    the staging does, then each pixel's slot on the path its (sub-tile,
    warp) takes: covered (f = e), rows only (a select on the column) or
    partial (the select per pixel)."""
    B, T = idx.shape[:2]
    S = tile_h // SUB_ROWS
    t = torch.arange(T)
    xf = (((t % n_tx) * TILE_W)[:, None] + torch.arange(TILE_W)[None, :]).float()
    xf = xf.reshape(1, T, 1, 1, TILE_W)
    yb = (((t // n_tx) * tile_h)[:, None] + SUB_ROWS * torch.arange(S)[None, :]).float()
    yb = yb.reshape(1, T, S, 1, 1)  # each sub-tile's first row
    yf = yb + torch.arange(SUB_ROWS).float().reshape(1, 1, 1, SUB_ROWS, 1)
    ye = yb + (SUB_ROWS - 1)
    wx0 = xf - (torch.arange(TILE_W) % WARP).float()  # each column's warp's first
    wx1 = wx0 + (WARP - 1)
    sub = (B, T, S, SUB_ROWS, TILE_W)
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
            pk[:, r, :, None, None, None] for r in range(13))
        # staged once per (splat, sub-tile): qy and the quadratic's row part
        qy = yf - cy  # [B, T, S, 4, 1]
        if mode == "bf16":
            qy = _bf(qy)
            yy = _bf(_bf(nsyy) * _bf(qy * qy))
        else:
            yy = nsyy * (qy * qy)
            if mode == "fast":
                yy = yy + a
        # the pixel's slot
        qx = xf - cx
        if mode == "fast":
            e = torch.exp2(nsxx * (qx * qx) + (nsxy * (qx * qy) + yy))
        elif mode == "exact":
            e = torch.exp(nsxx * (qx * qx) + nsxy * (qx * qy) + yy) * a
        else:  # each bf16 operation: the f32 result rounded
            qx = _bf(qx)
            txx = _bf(_bf(nsxx) * _bf(qx * qx))
            quad = _bf(txx + _bf(_bf(nsxy) * _bf(qx * qy)))
            quad = _bf(quad + yy)
            e = _bf(torch.exp(quad.to(torch.bfloat16)).float() * _bf(a))
        if mode == "fast":
            inx, iny = (xf > x0) & (xf < x1), (yf > y0) & (yf < y1)
            keep, hit = (y0 < ye) & (y1 > yb), (x0 < wx1) & (x1 > wx0)
            rows_in, cols_in = (y0 < yb) & (y1 > ye), (x0 < wx0) & (x1 > wx1)
        else:
            inx, iny = (xf >= x0) & (xf <= x1), (yf >= y0) & (yf <= y1)
            keep, hit = ~((y1 < yb) | (y0 > ye)), ~((x1 < wx0) | (x0 > wx1))
            rows_in, cols_in = (y0 <= yb) & (y1 >= ye), (x0 <= wx0) & (x1 >= wx1)
        # selects, never a multiply with a mask
        f = torch.where(rows_in & cols_in, e,
                        torch.where(rows_in, torch.where(inx, e, zero),
                                    torch.where(inx & iny, e, zero)))
        if mode == "fast":
            new = [ch + f * (c - ch) for ch, c in zip(canvas, (col_r, col_g, col_b))]
        elif mode == "exact":
            new = [(1.0 - f) * ch + f * c for ch, c in zip(canvas, (col_r, col_g, col_b))]
        else:
            omf = _bf(1.0 - f)
            new = [_bf(_bf(omf * ch) + _bf(f * _bf(c)))
                   for ch, c in zip(canvas, (col_r, col_g, col_b))]
        skip = ~keep | ~hit | (k >= cnt)[:, :, None, None, None]  # the walk stops at cnt
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


# ------------------------------------------------ hand-placed boxes, by path

HC, WC = 40, 256  # two list tiles across: 8 warps of 32 columns


def _hand_screen(case: str):
    """Screen-space splats [B, n] whose boxes put one path to work: "covered"
    (boxes on sub-tile and warp edges, or beyond), "rows_only" (every row,
    part of a warp's columns), "straddling" (neither), "overflow" (one
    column wide and most rows tall, its cross term so large that the
    quadratic is positive beside the column: exp overflows outside the box
    and stays finite in it), each over a few ordinary splats."""
    boxes = {
        "covered": [(0, 255, 0, 39), (32, 191, 4, 35), (64, 127, 8, 23), (0, 95, 0, 15)],
        "rows_only": [(10, 50, 0, 39), (100, 140, 0, 39), (33, 62, 0, 39), (130, 250, 0, 39)],
        "straddling": [(20, 100, 5, 18), (60, 230, 2, 30), (1, 254, 1, 38), (31, 160, 7, 9)],
        "overflow": [(70, 70, 3, 36), (0, 255, 0, 39), (140, 140, 2, 38)],
    }[case]
    rng = np.random.default_rng(len(case))
    n = len(boxes) + 3
    f = {k: np.zeros((B, n), np.float32) for k in tcodec.SplatScreen._fields}
    for i in range(n):
        if i < len(boxes):
            x0, x1, y0, y1 = boxes[i]
        else:  # an ordinary splat somewhere
            x0, y0 = rng.integers(0, WC - 40), rng.integers(0, HC - 10)
            x1, y1 = x0 + rng.integers(1, 40), y0 + rng.integers(1, 10)
        sx, sy = max(x1 - x0, 1) / 6.0, max(y1 - y0, 1) / 6.0
        f["x0"][:, i], f["x1"][:, i], f["y0"][:, i], f["y1"][:, i] = x0, x1, y0, y1
        f["cx"][:, i] = (x0 + x1) / 2.0 + rng.uniform(-0.5, 0.5, B)
        f["cy"][:, i] = (y0 + y1) / 2.0 + rng.uniform(-0.5, 0.5, B)
        f["sxx"][:, i], f["syy"][:, i] = 1.0 / sx**2, 1.0 / sy**2
        f["sxy"][:, i] = rng.uniform(-0.5, 0.5, B) / (sx * sy)
        if case == "overflow" and x0 == x1:  # thin and long: its column is its box
            f["cx"][:, i] = float(x0)
            f["sxx"][:, i], f["syy"][:, i], f["sxy"][:, i] = 0.02, 0.02, 6.0
        for c in ("rc", "gc", "bc"):
            f[c][:, i] = rng.uniform(0.0, 1.0, B)
        f["a"][:, i] = rng.uniform(0.3, 1.0, B)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    for k in ("x0", "x1", "y0", "y1"):
        t[k] = t[k].to(torch.int32)
    return tcodec.SplatScreen(**t)


def _hand_lists(p, tile_h, mode):
    n_tx, n_ty = WC // TILE_W, -(-HC // tile_h)
    n = p.cx.shape[1]
    idx, cnt = rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, tile_h, TILE_W, n)
    feats = rc._splat_feats_turbo(p) if mode == "fast" else rc._splat_feats_fast(p)
    return cnt, idx.contiguous(), feats, n_tx, n_ty


@pytest.mark.parametrize("tile_h", [8, 16])
@pytest.mark.parametrize("case", ["covered", "rows_only", "straddling", "overflow"])
@pytest.mark.parametrize("mode", ["exact", "fast", "bf16"])
def test_paths_match_plain_walk(mode, case, tile_h):
    p = _hand_screen(case)
    cnt, idx, feats, n_tx, n_ty = _hand_lists(p, tile_h, mode)
    Hp = n_ty * tile_h
    paths = rc.walk_path_counts(cnt, idx, feats, n_tx, tile_h, mode)
    if case == "covered":
        assert paths["covered"] > 0
    elif case == "rows_only":
        assert paths["rows_only"] > paths["covered"]
    elif case == "straddling":
        assert paths["partial"] > 0 and paths["rows_only"] > 0 and paths["covered"] > 0
    else:
        assert paths["partial"] > 0
        # at pixel (71, 2), beside the thin splat's column 70 and above its
        # rows 3-36 but in a sub-tile and warp that walk it, exp overflows;
        # in its column it does not
        s0 = feats[:, :, 0]
        qx, qy = 71.0 - s0[:, 0], 2.0 - s0[:, 1]
        quad = s0[:, 2] * (qx * qx) + s0[:, 3] * (qx * qy) + s0[:, 4] * (qy * qy)
        e = torch.exp2(quad + s0[:, 8]) if mode == "fast" else torch.exp(quad)
        assert bool(torch.isinf(e).all())
        assert bool(torch.isfinite(torch.exp(s0[:, 4] * (qy * qy))).all())

    planes = _replay(cnt, idx, feats, n_tx, tile_h, mode, None)
    want = rc._walk_plain(cnt, idx, feats, n_tx, tile_h, TILE_W, BG, mode, None)
    T = idx.shape[1]
    for got, ref in zip(planes, want):
        assert bool(torch.isfinite(ref).all())
        assert torch.equal(got.reshape(B, T, tile_h, TILE_W), ref)
    target_p, w_p = rc.pad_planes(torch.from_numpy(image(5, HC, WC)),
                                  torch.from_numpy(weights(6, HC, WC)), Hp, WC)
    got = _kernel_sums(planes, target_p, w_p, n_tx, tile_h)
    ref = rc.fitness_tiles_plain(cnt, idx, feats, target_p, w_p, n_tx, tile_h, TILE_W, BG, mode)
    torch.testing.assert_close(got, ref, rtol=5e-5, atol=0)


def _brute_paths(cnt, idx, feats, n_tx, tile_h, mode):
    """walk_path_counts one visit at a time, with the kernel's tests."""
    fast = mode == "fast"
    out = dict.fromkeys(("dropped", "skipped", "covered", "rows_only", "partial"), 0)
    Bn, T, _ = idx.shape
    for b in range(Bn):
        for t in range(T):
            tx0, ty0 = (t % n_tx) * TILE_W, (t // n_tx) * tile_h
            for k in range(int(cnt[b, t])):
                x0, x1, y0, y1 = (float(v) for v in feats[b, 9:13, int(idx[b, t, k])])
                for s in range(tile_h // SUB_ROWS):
                    yb = float(ty0 + SUB_ROWS * s)
                    ye = yb + SUB_ROWS - 1
                    for w in range(TILE_W // WARP):
                        wx0 = float(tx0 + WARP * w)
                        wx1 = wx0 + WARP - 1
                        if fast:
                            kept, hit = y0 < ye and y1 > yb, x0 < wx1 and x1 > wx0
                            rows, cols = y0 < yb and y1 > ye, x0 < wx0 and x1 > wx1
                        else:
                            kept, hit = not (y1 < yb or y0 > ye), not (x1 < wx0 or x0 > wx1)
                            rows, cols = y0 <= yb and y1 >= ye, x0 <= wx0 and x1 >= wx1
                        path = ("dropped" if not kept else "skipped" if not hit
                                else "partial" if not rows else "covered" if cols
                                else "rows_only")
                        out[path] += 1
    out["visits"] = sum(out.values())
    return out


@pytest.mark.parametrize("lists", ["random_8", "random_32", "covered", "straddling"])
@pytest.mark.parametrize("mode", ["exact", "fast", "bf16"])
def test_walk_path_counts_match_brute_force(mode, lists):
    if lists.startswith("random"):
        tile_h = int(lists.split("_")[1])
        p = _screen()
        n_tx, n_ty = -(-W // TILE_W), -(-H // tile_h)
        cnt, idx = _lists(p, n_tx, n_ty, tile_h)
        feats = rc._splat_feats_turbo(p) if mode == "fast" else rc._splat_feats_fast(p)
    else:
        tile_h = 8
        cnt, idx, feats, n_tx, _ = _hand_lists(_hand_screen(lists), tile_h, mode)
    got = rc.walk_path_counts(cnt, idx, feats, n_tx, tile_h, mode)
    assert got == _brute_paths(cnt, idx, feats, n_tx, tile_h, mode)
    assert got["visits"] == int(cnt.sum()) * (tile_h // SUB_ROWS) * (TILE_W // WARP)
    assert min(got[k] for k in ("dropped", "skipped", "partial")) > 0


def _listing(lines):
    """A cuobjdump -sass listing of one kernel from (opcode, operands) pairs."""
    out = ["        Function : _ZN3ggs14fitness_kernelILi0EEEvNS_10WalkParamsE"]
    for i, (op, args) in enumerate(lines):
        pred = ""
        if op.startswith("@"):
            pred, op = op.split(" ", 1)
        out.append(f"        /*{16 * i:04x}*/  {pred:>6} {op} {args} ;  /* 0x000000 */")
        out.append("                                                  /* 0x000000 */")
    return "\n".join(out)


def test_sass_splat_loop_counts_each_path():
    """tools/fitness_walk_times.py --sass: the inner splat loop (the innermost
    backward branch with an exp and no barrier) split into blocks, each blend
    path's instructions a pair, its shared tests counted in."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "fitness_walk_times.py")
    spec = importlib.util.spec_from_file_location("fitness_walk_times", path)
    fwt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fwt)
    ex2 = [("MUFU.EX2", "R1, R1")] * 4
    lines = ([("BAR.SYNC.DEFER_BLOCKING", "0x0")]  # 0x00: the chunk loop's barrier
             + [("LDS.128", "R12, [UR7]"), ("FSETP.GT.AND", "P4, PT, R12, R5, PT"),  # 0x10
                ("@P4 BRA", "0x1a0"), ("FSETP.LE.AND", "P5, PT, R12, R4, PT"),
                ("@P5 BRA", "0x110")]
             + ex2 + [("FSEL", "R2, R1, RZ, P1")] * 4 + [("FSETP.GE.AND", "P1, PT, R1, R2, PT")] * 2
             + [("BRA", "0x1a0")]  # 0x60-0x100: a path with a select on the column
             + ex2 + [("FMUL", "R2, R1, R1")] * 5  # 0x110-0x190: the covered path
             + [("BSYNC", "B0"), ("@P0 BRA", "0x10"), ("BRA", "0x0"), ("EXIT", "")])
    fns = fwt._functions(_listing(lines))
    (ins,) = fns.values()
    loop = fwt.splat_loop(ins)
    assert loop["found"] and loop["range"] == ["0x10", "0x1b0"]
    assert loop["instructions"] == 27 and loop["opcodes"]["MUFU.EX2"] == 8
    assert [b["n"] for b in loop["blocks"]] == [3, 2, 11, 9, 2]
    assert loop["shared"] == 7
    assert loop["per_pair_by_path"] == {"rows_only": (11 + 7) / 4, "covered": (9 + 7) / 4}
    assert fwt.splat_loop(ins[:10])["found"] is False  # no backward branch
