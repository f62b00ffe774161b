#!/usr/bin/env python3
"""Device times of the port's gradient walks K6 (bwd_tiles) and K7
(lossgrad_tiles) in one checkout of this repository, for comparing two
commits on the same card.

    python3 tools/grad_walk_times.py [--tree DIR] [--reps N] [--save OUT] [--sass]
    python3 tools/grad_walk_times.py --compare OUT_A OUT_B
    python3 tools/grad_walk_times.py --turns PARENT CHANGE OUT_DIR [--reps N] [--sass]

DIR (default: this checkout) is the root of a checkout whose
ggs_tpu_torch package and chip_smoke.py are timed; its kernels are built
from its own sources. The shapes are chip_smoke.py's: K7 and K6 at
run_grad's default (B=1, N=2000, 512x512, the port's list tiles) and at the
memetic elite batch (B=8, N=512), and K6 with d(init) on the last chained
pass of grad-10k-1024 (B=1, N=10,000, 1024x1024). Each time is the mean of
CUDA events over N launches after a warm-up. Prints one JSON line with the
card's name and power limit as nvidia-smi gives them, and beside the times
each case's census (`census`: how the walks take its lists, by cover form).
Needs a CUDA card; imports nothing of JAX.

With --sass it also prints ptxas's report of grad_kernel<false> (K6) and
<true> (K7) (registers, shared memory, spills) and each kernel's splat
loops from the built library (cuobjdump -sass): the innermost backward
branches that hold no barrier and an exp or a shuffle, in address order (K6:
the T pass, the G replay, the G forward walk; K7 its forward walk first), by
opcode and by basic block, each block with its MUFU.EX2 count. A block with
four is one cover form over a thread's four rows, so that form's
instructions a (splat, pixel) pair are (its block + the loop's blocks
without an exp) / 4; a loop without an exp (the G forward walk) counts
its whole body over 4, the reduction's share included.

With --save OUT it also writes into OUT (a JSON file) a hash of each
case's outputs (K7's partials and gradients, K6's gradients, and with
d(init) on the chained pass) and of the gradient entry points' at
run_grad's default (render_grad.fused_value_and_grad over the tight box,
and over the fast tier's eps boxes and corner cull at eps 8e-2; the genome
gradient of render_diff's weighted SSE at grad-10k-1024, two chained
passes). --compare reads two such files (needs no card), prints one JSON
line saying which are equal, and exits 1 where any differs. The tool runs
on a checkout of an older commit too (--tree): it reads the cases through
that checkout's chip_smoke.py and the entry points' public arguments.

To compare a parent commit with a change, unpack the parent (`git archive`)
into a directory that .gitignore lists and run, in one call on one card,
parent, change, change, parent: --turns does that, each in its own process
(`--tree`, saving into OUT_DIR), then compares the first parent's hashes
with each change's and exits 1 where any differs.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

TILE_W, SUB_ROWS, WARP = 128, 4, 32  # walk_grad.cu: kTileW, kRows, a warp's columns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    ap.add_argument("--sass", action="store_true",
                    help="ptxas's report and the splat loops of K6 and K7")
    ap.add_argument("--turns", nargs=3, metavar=("PARENT", "CHANGE", "OUT_DIR"), default=None)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if args.turns:
        return turns(*args.turns, reps=args.reps, sass=args.sass)
    import torch

    if not torch.cuda.is_available():
        print("grad_walk_times: needs a CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from ggs_tpu_torch.config import MaskConfig
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, mask, render_cuda, render_grad as rg
    from ggs_tpu_torch.utils import io

    for mod in (cs, render_cuda):  # the tree's own modules, not another checkout's
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"{mod.__name__} was imported from {mod.__file__}, not {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    render_cuda.build()
    ms, hashes, forms = {}, {}, {}
    for key, (B, N, seed) in {"B1_N2000": (1, 2000, 10), "B8_N512": (8, 512, 11)}.items():
        c = cs.make_grad_case(B, N, 512, 512, seed=seed)
        forms[key] = census(c["cnt"], c["idx"], c["feats"], c["n_tx"], c["tile_h"])
        ms[f"K7_{key}"] = cs.cuda_ms(lambda: cs.run_k7(c), args.reps)
        ms[f"K6_{key}"] = cs.cuda_ms(lambda: cs.run_k6(c), args.reps)
        hashes[f"K7_{key}"] = cs.tensor_hash(*cs.run_k7(c))
        hashes[f"K6_{key}"] = cs.tensor_hash(cs.run_k6(c))
        del c
    side, n = cs.BIG_SIDE, cs.BIG_N
    gen = torch.Generator(device="cuda").manual_seed(32)
    g9 = codec.genome_to_renderer(genome.new_population(gen, 1, n, side, side, device="cuda"))
    tgt = io.ensure_hw(io.synthetic_target(side, side), side, side, device="cuda")
    cg = cs.chained_grad_case(g9, tgt, mask.mask_from_config(tgt, side, side, MaskConfig()))
    six = tuple(cg[f] for f in ("cnt", "idx", "feats", "g_img", "n_tx", "tile_h", "tile_w"))
    forms["grad_10k_1024_init"] = census(*six[:3], cg["n_tx"], cg["tile_h"])
    ms["K6_grad_10k_1024_init"] = cs.cuda_ms(lambda: rg.bwd_tiles(*six, cs.BG, init=cg["init"]),
                                            max(1, args.reps // 2))
    hashes["K6_grad_10k_1024_init"] = cs.tensor_hash(*rg.bwd_tiles(*six, cs.BG, init=cg["init"]))
    del cg
    if args.save:
        hashes.update(entry_point_hashes(torch, cs, rg, codec, genome, io, g9, tgt))
        with open(args.save, "w") as fh:
            json.dump(hashes, fh)
    out = {"tree": tree, "card": card, "device": torch.cuda.get_device_name(0),
           "reps": args.reps, "ms": ms, "census": forms}
    if args.sass:
        k = render_cuda.build()
        out["ptxas"] = ptxas_report(k.logs["walk_grad"])
        out["sass_loops"] = sass_loops(k.paths["walk_grad"])
    print(json.dumps(out), flush=True)
    return 0


def census(cnt, idx, feats, n_tx, tile_h) -> dict:
    """How the gradient walks K6 and K7 take a launch's lists (cnt [B, T],
    idx [B, T, L], feats [B, 13, N+1] with the integer boxes in rows 9-12, on
    list tiles tile_h x 128): per list slot k < cnt of each item (a sub-tile
    of 4 rows) and, for a slot whose rows meet the sub-tile's, per warp of 32
    columns, with the kernel's tests. Counts: "slots"; "kept", the slots
    whose box rows meet the sub-tile's (the others cost a block-uniform
    test); "rows_in", the kept slots whose box holds the sub-tile's 4 rows;
    "visits", the (kept slot, warp) pairs whose box columns meet the warp's
    (the others cost a warp-uniform test), by cover: "all" (the box holds
    the 4 rows and the warp's 32 columns: the form with no select),
    "rows_only" (the rows but not every column) and "partial" (not every
    row), both walked in the form with the select per pixel. Shares: kept /
    slots, rows_in / kept, visits / (4 kept), and each cover's of the
    visits. Plain PyTorch on the lists' device; no walk calls it."""
    import torch

    B, T, L = idx.shape
    dev = idx.device
    box = torch.gather(feats[:, 9:13], 2, idx.long().reshape(B, 1, T * L).expand(B, 4, T * L))
    x0, x1, y0, y1 = box.reshape(B, 4, T, L).unbind(1)
    live = torch.arange(L, device=dev)[None, None, :] < cnt[:, :, None]
    t = torch.arange(T, device=dev)
    tx0 = ((t % n_tx) * TILE_W).to(torch.float32)[None, :, None]
    ty0 = ((t // n_tx) * tile_h).to(torch.float32)[None, :, None]
    n = dict.fromkeys(("slots", "kept", "rows_in", "visits", "all", "rows_only", "partial"), 0)
    for sub in range(tile_h // SUB_ROWS):
        yb = ty0 + float(SUB_ROWS * sub)
        ye = yb + float(SUB_ROWS - 1)
        kept = live & ~((y1 < yb) | (y0 > ye))
        rows = kept & (y0 <= yb) & (y1 >= ye)
        n["slots"] += int(live.sum())
        n["kept"] += int(kept.sum())
        n["rows_in"] += int(rows.sum())
        for w in range(TILE_W // WARP):
            wx0 = tx0 + float(WARP * w)
            wx1 = wx0 + float(WARP - 1)
            hit = kept & ~((x1 < wx0) | (x0 > wx1))
            cols = (x0 <= wx0) & (x1 >= wx1)
            n["visits"] += int(hit.sum())
            n["all"] += int((hit & rows & cols).sum())
            n["rows_only"] += int((hit & rows & ~cols).sum())
            n["partial"] += int((hit & ~rows).sum())
    share = {"kept": n["kept"] / max(n["slots"], 1), "rows_in": n["rows_in"] / max(n["kept"], 1),
             "visits": n["visits"] / max(4 * n["kept"], 1)}
    share.update({k: n[k] / max(n["visits"], 1) for k in ("all", "rows_only", "partial")})
    return {**n, "share": share}


def _fitness_walk_times():
    """tools/fitness_walk_times.py as a module: its SASS readers."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fitness_walk_times.py")
    spec = importlib.util.spec_from_file_location("fitness_walk_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_report(log: str) -> dict:
    """ptxas's lines (registers, shared memory, spills) for each entry
    function whose name holds grad_kernel, from the build log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            cur = m.group(1) if "grad_kernel" in m.group(1) else None
            continue
        if cur and ("Used" in line or "spill" in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    return out


def walk_loops(ins: list, fwt) -> list:
    """The splat loops of one kernel's instructions (see the module's --sass)."""
    targets = {fwt._target(op, args) for _, op, args in ins} - {None}
    loops = []
    for a, op, args in ins:
        t = fwt._target(op, args)
        if t is None or t > a:
            continue
        body = [i for i in ins if t <= i[0] <= a]
        ops = [i[1] for i in body]
        if any(o.startswith("BAR") for o in ops):
            continue
        if "MUFU.EX2" in ops or any(o.startswith("SHFL") for o in ops):
            loops.append((t, a, body))
    # the innermost: no other such loop lies inside
    inner = [lp for lp in loops
             if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    out = []
    for lo, hi, body in sorted(inner, key=lambda lp: lp[0]):
        blocks, cur = [], []
        for i in body:
            if cur and i[0] in targets:
                blocks.append(cur)
                cur = []
            cur.append(i)
            if i[1].startswith("BRA") or i[1] == "EXIT":
                blocks.append(cur)
                cur = []
        if cur:
            blocks.append(cur)
        rows = [{"start": hex(b[0][0]), "n": len(b), "ex2": sum(i[1] == "MUFU.EX2" for i in b),
                 "opcodes": fwt._count(b)} for b in blocks]
        shared = sum(r["n"] for r in rows if r["ex2"] == 0)
        ex2 = sum(r["ex2"] for r in rows)
        per_pair = ({f"{fwt._path(r['opcodes'])}@{r['start']}": (r["n"] + shared) / 4
                     for r in rows if r["ex2"] == 4} if ex2 else {"whole": len(body) / 4})
        out.append({"range": [hex(lo), hex(hi)], "instructions": len(body), "ex2": ex2,
                    "opcodes": fwt._count(body), "blocks": rows, "shared": shared,
                    "per_pair": per_pair})
    return out


def sass_loops(so: str) -> dict:
    """K6's and K7's splat loops in the library `so` (walk_loops)."""
    fwt = _fitness_walk_times()
    fns = fwt.sass_functions(so)
    return {"K6 grad_kernel<false>": walk_loops(fwt._kernel(fns, "grad_kernelILb0E"), fwt),
            "K7 grad_kernel<true>": walk_loops(fwt._kernel(fns, "grad_kernelILb1E"), fwt)}


def turns(parent: str, change: str, out_dir: str, reps: int, sass: bool) -> int:
    """Parent, change, change, parent, each in its own process; then the
    first parent's hashes against each change's (see the module's --turns)."""
    os.makedirs(out_dir, exist_ok=True)
    saved = {}
    for i, (side, tree) in enumerate((("parent", parent), ("change", change),
                                      ("change", change), ("parent", parent))):
        out = os.path.join(out_dir, f"{i}_{side}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree, "--reps", str(reps),
               "--save", out] + (["--sass"] if sass and i < 2 else [])
        print(f"== turn {i} {side} {tree}", flush=True)
        rc = subprocess.run(cmd, timeout=1800).returncode
        if rc != 0:
            print(f"grad_walk_times: turn {i} ({side}) exited {rc}", file=sys.stderr)
            return rc
        saved.setdefault(side, []).append(out)
    return max(compare(saved["parent"][0], b) for b in saved["change"])


def entry_point_hashes(torch, cs, rg, codec, genome, io, g9_big, tgt_big) -> dict:
    """Hashes of the gradient entry points' outputs (see the module's --save)."""
    from ggs_tpu_torch.ops import mask

    out = {}
    H = W = 512
    g = genome.new_population(torch.Generator(device="cuda").manual_seed(12), 1, 2000, H, W,
                              device="cuda")
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device="cuda")
    wm = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
    for key, kw in {"tight": dict(box="tight"),
                    "fast_corner": dict(cull_eps=8e-2, corner_cull=True)}.items():
        (loss, fits), grads = rg.fused_value_and_grad(g, tgt, wm, H, W, **kw)
        out[f"fused_B1_N2000_{key}"] = cs.tensor_hash(loss, fits, grads)
    side = cs.BIG_SIDE
    g9 = g9_big.detach().clone().requires_grad_(True)
    img = rg.render_diff(g9, side, side, box="tight")
    (grad,) = torch.autograd.grad(torch.sum((img - tgt_big) ** 2), g9)
    out["render_diff_grad_10k_1024"] = cs.tensor_hash(img, grad)
    return out


def compare(a: str, b: str) -> int:
    """Which hashes of two --save files are equal; 1 where any differs."""
    with open(a) as fh:
        ha = json.load(fh)
    with open(b) as fh:
        hb = json.load(fh)
    equal = {k: ha.get(k) == hb.get(k) for k in sorted(set(ha) | set(hb))}
    print(json.dumps({"equal": equal, "all_equal": all(equal.values())}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
