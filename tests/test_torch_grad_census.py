"""tools/grad_walk_times.py: the census of how the gradient walks
(csrc/walk_grad.cu: K6, K7) take a launch's lists by cover form, against a
count one visit at a time with the kernel's tests, on hand-placed boxes
that take every form and on random ones; and its reader of the kernels'
splat loops on a hand-made cuobjdump listing."""
import importlib.util
import os

import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

TILE_W, SUB_ROWS, WARP = 128, 4, 32


def _tool():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "grad_walk_times.py")
    spec = importlib.util.spec_from_file_location("grad_walk_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (x0, x1, y0, y1): each cover form in the sub-tile of rows 4-7
HAND_BOXES = [
    (32, 63, 4, 7),  # exactly warp 1's columns and the sub-tile's rows: all
    (0, 255, 0, 15),  # every column, rows 0-15: all
    (40, 100, 3, 12),  # the rows, edges inside warps 1 and 3: rows only
    (10, 70, 5, 5),  # one row: partial
    (60, 140, 6, 9),  # two rows, across the tiles' seam: partial
    (90, 200, 0, 6),  # three rows: partial
    (230, 255, 4, 7),  # the last tile's last column, the canvas edge: rows only
    (224, 255, 4, 15),  # the last warp whole: all
    (0, 5, 9, 14),  # rows below the sub-tile: dropped there
    (129, 129, 0, 15),  # one column
]


def _lists(boxes, B, H, W, tile_h):
    """Tile lists of boxes [B, n, 4] by brute force: (cnt, idx, feats with
    the boxes in rows 9-12, n_tx), each list ascending, padded with n."""
    n = boxes.shape[1]
    n_tx, n_ty = W // TILE_W, -(-H // tile_h)
    T = n_tx * n_ty
    lists = [[[] for _ in range(T)] for _ in range(B)]
    for b in range(B):
        for t in range(T):
            tx0, ty0 = (t % n_tx) * TILE_W, (t // n_tx) * tile_h
            for s in range(n):
                x0, x1, y0, y1 = (int(v) for v in boxes[b, s])
                if x1 >= tx0 and x0 <= tx0 + TILE_W - 1 and y1 >= ty0 and y0 <= ty0 + tile_h - 1:
                    lists[b][t].append(s)
    L = max(1, max(len(x) for per in lists for x in per))
    cnt = torch.tensor([[len(x) for x in per] for per in lists], dtype=torch.int32)
    idx = torch.full((B, T, L), n, dtype=torch.int32)
    for b in range(B):
        for t in range(T):
            idx[b, t, :len(lists[b][t])] = torch.tensor(lists[b][t], dtype=torch.int32)
    feats = torch.zeros((B, 13, n + 1))
    feats[:, 9:13, :n] = boxes.permute(0, 2, 1).float()
    return cnt, idx, feats, n_tx


def _brute(cnt, idx, feats, n_tx, tile_h):
    """The census one visit at a time."""
    out = dict.fromkeys(("slots", "kept", "rows_in", "visits", "all", "rows_only", "partial"), 0)
    B, T, _ = idx.shape
    for b in range(B):
        for t in range(T):
            tx0, ty0 = (t % n_tx) * TILE_W, (t // n_tx) * tile_h
            for k in range(int(cnt[b, t])):
                x0, x1, y0, y1 = (float(v) for v in feats[b, 9:13, int(idx[b, t, k])])
                for sub in range(tile_h // SUB_ROWS):
                    yb = float(ty0 + SUB_ROWS * sub)
                    ye = yb + SUB_ROWS - 1
                    out["slots"] += 1
                    if y1 < yb or y0 > ye:
                        continue
                    out["kept"] += 1
                    rows = y0 <= yb and y1 >= ye
                    out["rows_in"] += rows
                    for w in range(TILE_W // WARP):
                        wx0 = float(tx0 + WARP * w)
                        wx1 = wx0 + WARP - 1
                        if x1 < wx0 or x0 > wx1:
                            continue
                        out["visits"] += 1
                        cols = x0 <= wx0 and x1 >= wx1
                        out["partial" if not rows else "all" if cols else "rows_only"] += 1
    return out


def _random_boxes(B, n, H, W, seed):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randint(0, W, (B, n), generator=g)
    y0 = torch.randint(0, H, (B, n), generator=g)
    x1 = (x0 + torch.randint(0, 160, (B, n), generator=g)).clamp(max=W - 1)
    y1 = (y0 + torch.randint(0, 24, (B, n), generator=g)).clamp(max=H - 1)
    return torch.stack([x0, x1, y0, y1], dim=2)


@pytest.mark.parametrize("tile_h", [8, 16, 32, 64])
@pytest.mark.parametrize("boxes", ["hand", "random"])
def test_census_matches_brute_force(boxes, tile_h):
    gwt = _tool()
    H, W = 40, 256
    if boxes == "hand":
        bx = torch.tensor(HAND_BOXES)[None].expand(2, -1, -1).clone()
        bx[1, :, 2:] += 1  # the second image's boxes a row lower
        bx[1, :, 3] = bx[1, :, 3].clamp(max=H - 1)
    else:
        bx = _random_boxes(3, 40, H, W, seed=tile_h)
    cnt, idx, feats, n_tx = _lists(bx, bx.shape[0], H, W, tile_h)
    got = gwt.census(cnt, idx, feats, n_tx, tile_h)
    want = _brute(cnt, idx, feats, n_tx, tile_h)
    assert {k: got[k] for k in want} == want
    assert got["slots"] == int(cnt.sum()) * (tile_h // SUB_ROWS)
    assert got["visits"] == got["all"] + got["rows_only"] + got["partial"]
    sh = got["share"]
    assert sh["kept"] == want["kept"] / want["slots"]
    assert abs(sh["all"] + sh["rows_only"] + sh["partial"] - 1.0) < 1e-12
    if boxes == "hand":  # every form is taken
        assert min(want["all"], want["rows_only"], want["partial"]) > 0
        assert want["kept"] < want["slots"]


def _listing(fn, lines):
    """A cuobjdump -sass listing of one function from (opcode, operands) pairs."""
    out = [f"        Function : {fn}"]
    for i, (op, args) in enumerate(lines):
        pred = ""
        if op.startswith("@"):
            pred, op = op.split(" ", 1)
        out.append(f"        /*{16 * i:04x}*/  {pred:>6} {op} {args} ;  /* 0x000000 */")
    return "\n".join(out)


def test_walk_loops_count_each_form_and_the_forward_walk():
    """walk_loops: the innermost backward branches with no barrier and an exp
    or a shuffle, in address order; a block with four exps is one form, its
    instructions a pair (block + the loop's exp-free blocks) / 4; a loop with
    no exp counts its whole body over 4."""
    gwt = _tool()
    fwt = gwt._fitness_walk_times()
    ex2 = [("MUFU.EX2", "R1, R1")] * 4
    lines = ([("BAR.SYNC.DEFER_BLOCKING", "0x0")]  # 0x00: the chunk loop's barrier
             + [("LDS.128", "R12, [UR7]"), ("FSETP.GT.AND", "P4, PT, R12, R5, PT"),  # 0x10
                ("@P4 BRA", "0x1a0"), ("FSETP.LE.AND", "P5, PT, R12, R4, PT"),
                ("@P5 BRA", "0x110")]
             + ex2 + [("FSEL", "R2, R1, RZ, P1")] * 4 + [("FSETP.GE.AND", "P1, PT, R1, R2, PT")] * 2
             + [("BRA", "0x1a0")]  # 0x60-0x100: a form with a select on the column
             + ex2 + [("FMUL", "R2, R1, R1")] * 5  # 0x110-0x190: the form with no select
             + [("@P0 BRA", "0x10")]  # 0x1a0: the first loop's back edge
             + [("LDS.128", "R12, [UR7]"), ("FMUL", "R2, R1, R1")]  # 0x1b0: the second loop
             + [("SHFL.BFLY", "PT, R3, R2, 0x10, 0x1f")] * 3
             + [("@P1 BRA", "0x1b0"), ("BRA", "0x0"), ("EXIT", "")])
    fns = fwt._functions(_listing("_ZN8ggs_grad11grad_kernelILb0EEEvNS_10GradParamsE", lines))
    (ins,) = fns.values()
    first, second = gwt.walk_loops(ins, fwt)
    assert first["range"] == ["0x10", "0x1a0"] and first["ex2"] == 8
    assert [b["n"] for b in first["blocks"]] == [3, 2, 11, 9, 1]
    assert first["shared"] == 6
    assert first["per_pair"] == {"rows_only@0x60": (11 + 6) / 4, "covered@0x110": (9 + 6) / 4}
    assert second["range"] == ["0x1b0", "0x200"] and second["ex2"] == 0
    assert second["per_pair"] == {"whole": 6 / 4}
    assert gwt.walk_loops(ins[:10], fwt) == []  # no backward branch


def test_ptxas_report_reads_the_grad_kernels():
    gwt = _tool()
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN8ggs_grad14sub_sum_kernelEPKiS2_PKfS4_PfS5_iii'"
        " for 'sm_90a'",
        "ptxas info    : Used 32 registers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN8ggs_grad11grad_kernelILb0EEEvNS_10GradParamsE'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _ZN8ggs_grad11grad_kernelILb0EEEvNS_10GradParamsE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, 35904 bytes smem, 504 bytes cmem[0]",
    ])
    got = gwt.ptxas_report(log)
    assert got == {"_ZN8ggs_grad11grad_kernelILb0EEEvNS_10GradParamsE": [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 96 registers, 35904 bytes smem, 504 bytes cmem[0]"]}
