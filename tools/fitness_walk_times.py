#!/usr/bin/env python3
"""Device times of the port's forward walks (csrc/walk.cu: K1, K3, K1-bf16,
K2 and K2') in one checkout of this repository, for comparing two commits
on the same card; and a comparison of two checkouts' outputs on the same
lists.

    python3 tools/fitness_walk_times.py [--tree DIR] [--reps N] [--save OUT] [--sass] [--paths]
    python3 tools/fitness_walk_times.py --tree DIR --rates
    python3 tools/fitness_walk_times.py --compare OUT_A OUT_B

DIR (default: this checkout) is the root of a checkout whose
ggs_tpu_torch package and chip_smoke.py are timed; its kernels are built
from its own sources (a checkout whose render path has ops/screen.py;
time an older one with its own copy of this script). The cases are chip_smoke.py's, made from its seeds:
K1 at B=32 and B=512 and K3 (eps 2e-3, the corner cull) at B=32, at
run_ga's shape (512x512, N=512, 64x128 tiles); K1-bf16 on the bf16 GA's
lists (the reference box) and K1 on the same lists; K2 and K3's canvas at
B=1 on that canvas; and K2' (RenderDiff's forward, K2's kernel) on the last
of grad-10k-1024's two chained passes (B=1, N=10,000, 1024x1024, 16x128
list tiles, from the first pass's canvas); and from a seeded init canvas
in [0.05, 0.95], K1, K3 and K1-bf16 on their B=32 lists and K2 and K3's
canvas on their B=1 lists. Each time ("ms") is the mean of
CUDA events over N launches after a warm-up; "device_ms" is the walk
kernel's own device time per launch under torch.profiler, which differs
where the wrapper's host time per call exceeds the kernel's (B=1). Per case
it also counts the lists' work: the pair-pixels inside a listed splat's box
and the pixel slots a walk on 4x128 sub-tiles computes (128 for each
(splat, sub-tile, 32-column warp) whose rows and columns meet). Prints one
JSON line with the card's name and power limit as nvidia-smi gives them.
Needs a CUDA card; imports nothing of JAX.

With --save OUT it also writes each case's output (the canvases of K2, K3
and K2', the partials of K1, K3 and K1-bf16) and a hash of its lists into
OUT. --compare then reads two such directories (needs no card) and prints
one JSON line: whether each case's lists are the same, whether its canvas
is the same bits, whether its partials are the same bits and their largest
relative difference; it exits 1 where lists or canvases differ.

With --rates it times, instead of the kernels, the host-bound main
paths at their defaults as chip_smoke.py does: GA generations/s (run_ga's
512x512, N=512, population 32, importance mask; exact-tight and fast blocks
of chip_smoke.GA_BLOCK_GENS alternating, the median of GA_BLOCKS each) and
Adam steps/s at run_grad's (N=2000, exact-tight, mask 0.7; the median of
ADAM_BLOCKS blocks).

With --sass it also prints K1-bf16's (fitness_kernel<2>) bf16x2
instructions in the built library by opcode (cuobjdump -sass), and the
HFMA2s that are neither an add (a 1.0 multiplicand) nor a multiply (a -0.0
addend): a contracted multiply-add would drop one of the walk's roundings,
so that count must be 0 (the script exits 1 otherwise). For K1
(fitness_kernel<0>) and K2 (render_kernel<0>) it prints the inner splat
loop's instructions (the innermost backward branch whose range holds the
exp's MUFU.EX2 and no barrier) by opcode and by basic block, each block
with its MUFU.EX2 count: a block with four is one blend path over a
thread's four rows ("covered" without a select, "partial" with the row
tests, "rows_only" between), so that path's instructions a (splat, pixel)
pair are (its block + the loop's blocks without an exp) / 4, the loop's
share counted whole, an upper bound for a path that leaves the loop's
shared tests early.

With --paths it also prints, at the benchmark cells' shapes (the
flagship's 10,000 splats at 1024x1024 in its two passes, 16 candidates;
the photo's 512 splats at 384x512, P=32 and P=512; each a fresh
population, as ga.init draws it, on 64x128 list tiles), how the walk
takes each (splat, sub-tile, warp) visit
(`render_cuda.walk_path_counts`: dropped, skipped, covered, rows only,
partial) and the shares of the walked visits whose box holds the
sub-tile's 4 rows, and also the warp's 32 columns. A tree without
walk_path_counts prints none.

To compare a parent commit with a change, unpack the parent (`git archive`)
into a directory that .gitignore lists and run, in one call on one card,
parent, change, change, parent, saving the first two.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import warnings

CANVASES = ("K2_B1", "K3_canvas_B1", "K2p_grad_10k_1024", "K2_B1_init", "K3_canvas_B1_init")
PARTIALS = ("K1_B32", "K1_B512", "K3_B32", "K1_bf16_B32", "K1_B32_reference_box", "K1_B32_init",
            "K3_B32_init", "K1_bf16_B32_init")


def _k2p_case(cs, render_cuda, rg, codec, genome, torch):
    """The last pass of render_diff at grad-10k-1024, built as RenderDiff
    builds it: its lists on the gradient tiles (K5 from 256 tiles), its
    folded table, and as init the first pass's K2 canvas."""
    from ggs_tpu_torch.ops import screen

    side, n = cs.BIG_SIDE, cs.BIG_N
    gen = torch.Generator(device="cuda").manual_seed(32)
    g9 = codec.genome_to_renderer(genome.new_population(gen, 1, n, side, side, device="cuda"))
    t = screen.box_tier("tight")
    with torch.no_grad():
        p = screen.screen(g9, side, side, 3.0, t)
    pcs = screen.passes(p)
    init = None
    for i, pc in enumerate(pcs):
        geom = rg._geometry(side, side, pc.cx.shape[1], None, cs.BG, t)
        n_tx, _, th, tw = geom[:4]
        idx, cnt = rg._bin(pc, geom)
        feats = render_cuda._splat_feats_fast(pc)
        if i < len(pcs) - 1:
            init = render_cuda.render_tiles(cnt, idx, feats, n_tx, th, tw, cs.BG, init=init)
    return dict(cnt=cnt, idx=idx, feats=feats, n_tx=n_tx, tile_h=th, tile_w=tw, init=init)


def _slots(c, torch) -> dict:
    """In-box pair-pixels, and the pixel slots of the sub-tile walk: for every
    listed splat, 128 per (sub-tile of 4 rows, warp of 32 columns) that its
    box meets, the fast table's open thresholds read as in the walk."""
    cnt, idx, feats = c["cnt"], c["idx"], c["feats"]
    B, T, L = idx.shape
    th, tw = c["tile_h"], c["tile_w"]
    boxes = torch.gather(feats[:, 9:13, :], 2, idx.long().reshape(B, 1, T * L).expand(B, 4, T * L))
    x0, x1, y0, y1 = boxes.reshape(B, 4, T, L).unbind(1)
    if c.get("precision") == "fast":  # open thresholds -> the closed box
        x0, x1, y0, y1 = x0 + 1.0, x1 - 1.0, y0 + 1.0, y1 - 1.0
    t = torch.arange(T, device=idx.device)
    tx0 = ((t % c["n_tx"]) * tw).float()[None, :, None]
    ty0 = ((t // c["n_tx"]) * th).float()[None, :, None]
    valid = torch.arange(L, device=idx.device)[None, None, :] < cnt[:, :, None]
    rows = (torch.minimum(y1, ty0 + th - 1) - torch.maximum(y0, ty0) + 1).clamp_min(0)
    cols = (torch.minimum(x1, tx0 + tw - 1) - torch.maximum(x0, tx0) + 1).clamp_min(0)
    pair_px = int((rows.double() * cols * valid).sum())
    slots = 0
    for s in range(th // 4):
        ys = ty0 + 4 * s
        yhit = (y1 >= ys) & (y0 <= ys + 3) & valid
        for w in range(tw // 32):
            xs = tx0 + 32 * w
            slots += 128 * int((yhit & (x1 >= xs) & (x0 <= xs + 31)).sum())
    return {"pair_pixels": pair_px, "subtile_slots": slots}


def _profiled_ms(fn, n: int, torch) -> float:
    """The walk kernel's device time per call of fn under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():  # torch's note that events are cleared each cycle
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and ("fitness_kernel" in e.key
                                                 or "render_kernel" in e.key):
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
    return us / 1e3 / n


def _lists_hash(c) -> str:
    h = hashlib.sha256()
    for t in (c["cnt"], c["idx"], c["feats"]):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _functions(sass: str) -> dict:
    """cuobjdump -sass text -> {function: [(address, opcode, operands)]}."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            out[cur] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);", line)
        if cur is not None and m:
            out[cur].append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out


def sass_functions(so: str) -> dict:
    """The instructions of each function in the library `so` (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return _functions(subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                                     check=True, timeout=300).stdout)


def _kernel(fns: dict, key: str) -> list:
    return next((ins for name, ins in fns.items() if key in name), [])


def sass_report(fns: dict) -> dict:
    """K1-bf16's bf16x2 instructions by opcode, and its HFMA2s that fuse a
    multiply and an add."""
    ops, fused = {}, []
    for _, op, operands in _kernel(fns, "fitness_kernelILi2E"):
        if "BF16" not in op:
            continue
        args = [a.strip() for a in operands.split(",")]
        ops[op] = ops.get(op, 0) + 1
        if op.startswith("HFMA2"):
            add = len(args) == 5 and args[2] == args[3] and args[2] in ("1", "-1")
            mul = len(args) == 4 and args[3] == "-RZ"
            if not (add or mul):
                fused.append(f"{op} {operands}")
    return {"bf16x2_ops": ops, "fused_hfma2": fused}


def _target(op: str, args: str):
    """A branch's target address, or None."""
    if not op.startswith("BRA"):
        return None
    m = re.search(r"0x([0-9a-f]+)", args)
    return int(m.group(1), 16) if m else None


def _count(ins) -> dict:
    c = {}
    for _, op, _ in ins:
        c[op] = c.get(op, 0) + 1
    return dict(sorted(c.items(), key=lambda kv: (-kv[1], kv[0])))


def _path(opcodes: dict) -> str:
    """A blend path by its selects: none, on the column, or per pixel."""
    fsel = sum(c for o, c in opcodes.items() if o.startswith("FSEL"))
    fsetp = sum(c for o, c in opcodes.items() if o.startswith("FSETP"))
    return "covered" if fsel == 0 else "partial" if fsetp >= 8 else "rows_only"


def splat_loop(ins: list) -> dict:
    """The inner splat loop of one walk kernel's instructions: the innermost
    backward branch's range that holds a MUFU.EX2 and no BAR, by opcode and
    by basic block (split at branches and branch targets)."""
    loops = []
    for a, op, args in ins:
        t = _target(op, args)
        if t is not None and t <= a:
            body = [i for i in ins if t <= i[0] <= a]
            ops = [i[1] for i in body]
            if "MUFU.EX2" in ops and not any(o.startswith("BAR") for o in ops):
                loops.append((a - t, t, a, body))
    if not loops:
        return {"found": False}
    _, lo, hi, body = min(loops)
    targets = {_target(op, args) for _, op, args in ins} - {None}
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
             "opcodes": _count(b)} for b in blocks]
    shared = sum(r["n"] for r in rows if r["ex2"] == 0)
    return {"found": True, "range": [hex(lo), hex(hi)], "instructions": len(body),
            "opcodes": _count(body), "blocks": rows, "shared": shared,
            "per_pair_by_path": {_path(r["opcodes"]): (r["n"] + shared) / 4
                                 for r in rows if r["ex2"] == 4}}


def sass_loops(fns: dict) -> dict:
    """K1's and K2's inner splat loops (splat_loop)."""
    return {"K1 fitness_kernel<0>": splat_loop(_kernel(fns, "fitness_kernelILi0E")),
            "K2 render_kernel<0>": splat_loop(_kernel(fns, "render_kernelILi0E"))}


def path_shares(torch) -> dict:
    """The walk's paths at the cells' shapes (see the module's --paths)."""
    from ggs_tpu_torch.config import GenomeConfig
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, render_cuda, screen

    count = getattr(render_cuda, "walk_path_counts", None)
    if count is None:
        return {}
    shapes = {"flagship_1024x1024_n10000_B16": (16, 10000, 1024, 1024, 41),
              "photo_384x512_n512_P32": (32, 512, 384, 512, 42),
              "photo_384x512_n512_P512": (512, 512, 384, 512, 43)}
    out = {}
    for name, (B, N, H, W, seed) in shapes.items():
        gnm = GenomeConfig(n_splats=N)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g9 = codec.genome_to_renderer(genome.new_population(
            gen, B, N, H, W, gnm.min_scale, gnm.max_scale, device="cuda"))
        t = screen.tier("exact-tight")
        p = screen.screen(g9, H, W, 3.0, t)
        n_tx, n_ty = -(-W // 128), -(-H // 64)
        tot = {}
        for pc in screen.passes(p):  # each pass's own lists
            cnt, idx, feats = render_cuda._pass_lists(pc, n_tx, n_ty, 64, 128, None, t)
            for k, v in count(cnt, idx, feats, n_tx, 64, "exact").items():
                tot[k] = tot.get(k, 0) + v
        walked = tot["covered"] + tot["rows_only"] + tot["partial"]
        out[name] = {**tot, "walked": walked,
                     "rows_share": (tot["covered"] + tot["rows_only"]) / max(walked, 1),
                     "covered_share": tot["covered"] / max(walked, 1)}
    return out


def times(args) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fitness_walk_times: needs a CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, render_cuda, render_grad as rg

    for mod in (cs, render_cuda):  # the tree's own modules, not another checkout's
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"{mod.__name__} was imported from {mod.__file__}, not {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    render_cuda.build()
    reps = args.reps
    cases = {
        "K1_B32": cs.make_case(32, 512, 512, 512, "exact-tight"),
        "K1_B512": cs.make_case(512, 512, 512, 512, "exact-tight", seed=2),
        "K3_B32": cs.make_case(32, 512, 512, 512, "fast", seed=20, cull_eps=2e-3),
        "K1_bf16_B32": cs.make_case(32, 512, 512, 512, "bf16", seed=22),
        "K2_B1": cs.make_case(1, 512, 512, 512, "exact-tight", seed=3),
        "K3_canvas_B1": cs.make_case(1, 512, 512, 512, "fast", seed=3, cull_eps=2e-3),
        "K2p_grad_10k_1024": _k2p_case(cs, render_cuda, rg, codec, genome, torch),
    }
    cases["K1_B32_reference_box"] = cases["K1_bf16_B32"]
    k2p = cases["K2p_grad_10k_1024"]

    def run_k2p():
        return render_cuda.render_tiles(k2p["cnt"], k2p["idx"], k2p["feats"], k2p["n_tx"],
                                        k2p["tile_h"], k2p["tile_w"], cs.BG, init=k2p["init"])

    def from_init(c, kind):
        """A walk of case c's lists from a canvas in [0.05, 0.95] drawn from
        a fixed seed, as a chained pass starts from the one before."""
        gen = torch.Generator(device="cuda").manual_seed(5)
        B = c["idx"].shape[0]
        init = torch.rand((B, 3, *c["w_p"].shape), generator=gen, device="cuda") * 0.9 + 0.05
        lists = (c["cnt"], c["idx"], c["feats"])
        geom = (c["n_tx"], c["tile_h"], c["tile_w"], cs.BG)
        if kind == "canvas":
            walk = render_cuda.render_tiles_fast if c["precision"] == "fast" else \
                render_cuda.render_tiles
            return lambda: walk(*lists, *geom, init=init)
        walk = {"fast": render_cuda.fitness_tiles_fast, "bf16": render_cuda.fitness_tiles_bf16}.get(
            c["precision"], render_cuda.fitness_tiles)
        return lambda: walk(*lists, c["tgt_p"], c["w_p"], *geom, init=init)

    runs = {
        "K1_B32": (lambda: cs.run_k1(cases["K1_B32"]), reps),
        "K1_B512": (lambda: cs.run_k1(cases["K1_B512"]), max(1, reps // 5)),
        "K3_B32": (lambda: cs.run_k3(cases["K3_B32"]), reps),
        "K1_bf16_B32": (lambda: cs.run_k1_bf16(cases["K1_bf16_B32"]), reps),
        "K1_B32_reference_box": (lambda: cs.run_k1(cases["K1_bf16_B32"]), reps),
        "K2_B1": (lambda: cs.run_k2(cases["K2_B1"]), 2 * reps),
        "K3_canvas_B1": (lambda: cs.run_k3_canvas(cases["K3_canvas_B1"]), 2 * reps),
        "K2p_grad_10k_1024": (run_k2p, reps),
        "K1_B32_init": (from_init(cases["K1_B32"], "fitness"), reps),
        "K3_B32_init": (from_init(cases["K3_B32"], "fitness"), reps),
        "K1_bf16_B32_init": (from_init(cases["K1_bf16_B32"], "fitness"), reps),
        "K2_B1_init": (from_init(cases["K2_B1"], "canvas"), 2 * reps),
        "K3_canvas_B1_init": (from_init(cases["K3_canvas_B1"], "canvas"), 2 * reps),
    }
    ms = {k: cs.cuda_ms(fn, n) for k, (fn, n) in runs.items()}
    device_ms = {k: _profiled_ms(fn, n, torch) for k, (fn, n) in runs.items()}
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        for k, (fn, _) in runs.items():
            np.save(os.path.join(args.save, f"{k}.npy"), fn().cpu().numpy())
        with open(os.path.join(args.save, "lists.json"), "w") as fh:
            json.dump({k: _lists_hash(c) for k, c in cases.items()}, fh)
    out = {"tree": tree, "card": card, "device": torch.cuda.get_device_name(0), "reps": reps,
           "ms": ms, "device_ms": device_ms,
           "work": {k: _slots(c, torch) for k, c in cases.items()}}
    if args.sass:
        fns = sass_functions(render_cuda.build().paths["walk"])
        out["sass_k1_bf16"] = sass_report(fns)
        out["sass_splat_loops"] = sass_loops(fns)
    if args.paths:
        out["paths"] = path_shares(torch)
    print(json.dumps(out), flush=True)
    return 1 if args.sass and out["sass_k1_bf16"]["fused_hfma2"] else 0


def rates(args) -> int:
    import time

    import torch

    if not torch.cuda.is_available():
        print("fitness_walk_times: needs a CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from ggs_tpu_torch.config import GAConfig, GenomeConfig, MaskConfig
    from ggs_tpu_torch.models import ga
    from ggs_tpu_torch.ops import mask, objective, render_cuda
    from ggs_tpu_torch.utils import io

    for mod in (cs, render_cuda):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"{mod.__name__} was imported from {mod.__file__}, not {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    H = W = 512
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device="cuda")
    wm = mask.mask_from_config(tgt, H, W, MaskConfig())
    objs = {"exact_tight": objective.Objective(H=H, W=W, precision="exact-tight"),
            "fast": objective.Objective(H=H, W=W, precision="fast")}
    cfg = GAConfig(pop_size=32, generations=500_000)
    gnm = GenomeConfig(n_splats=512)
    states = {}
    for tier, obj in objs.items():
        st = ga.init(torch.Generator(device="cuda").manual_seed(9), obj, tgt, wm, cfg, gnm)
        states[tier], _ = ga.run_block(st, obj, tgt, wm, cfg, gnm, 20)
    torch.cuda.synchronize()
    blocks = {tier: [] for tier in objs}
    for i in range(cs.GA_BLOCKS):
        for tier in (("exact_tight", "fast") if i % 2 == 0 else ("fast", "exact_tight")):
            t0 = time.perf_counter()
            states[tier], m = ga.run_block(states[tier], objs[tier], tgt, wm, cfg, gnm,
                                           cs.GA_BLOCK_GENS)
            m.cpu()
            torch.cuda.synchronize()
            blocks[tier].append(cs.GA_BLOCK_GENS / (time.perf_counter() - t0))
    adam, adam_blocks = cs.adam_steps_per_s(objs["exact_tight"], tgt, wm, 2000, 13)[:2]
    out = {"tree": tree, "card": card, "device": torch.cuda.get_device_name(0),
           "ga_generations_per_s": {t: sorted(b)[len(b) // 2] for t, b in blocks.items()},
           "ga_blocks": blocks, "adam_steps_per_s_run_grad_defaults": adam,
           "adam_blocks": adam_blocks}
    print(json.dumps(out), flush=True)
    return 0


def compare(a: str, b: str) -> int:
    import numpy as np

    with open(os.path.join(a, "lists.json")) as fa, open(os.path.join(b, "lists.json")) as fb:
        la, lb = json.load(fa), json.load(fb)
    out = {"same_lists": {k: la[k] == lb.get(k) for k in la}}
    ok = all(out["same_lists"].values())
    out["same_canvas_bits"] = {}
    for k in CANVASES:
        xa, xb = np.load(os.path.join(a, f"{k}.npy")), np.load(os.path.join(b, f"{k}.npy"))
        same = xa.shape == xb.shape and np.array_equal(xa.view(np.int32), xb.view(np.int32))
        out["same_canvas_bits"][k] = bool(same)
        ok = ok and same
    out["partials_max_rel_diff"], out["same_partial_bits"] = {}, {}
    for k in PARTIALS:
        pa, pb = np.load(os.path.join(a, f"{k}.npy")), np.load(os.path.join(b, f"{k}.npy"))
        out["same_partial_bits"][k] = bool(pa.shape == pb.shape and
                                           np.array_equal(pa.view(np.int32), pb.view(np.int32)))
        xa, xb = pa.astype(np.float64), pb.astype(np.float64)
        rel = np.abs(xa - xb) / np.maximum(np.abs(xb), 1e-30)
        out["partials_max_rel_diff"][k] = float(rel.max())
    print(json.dumps({"a": os.path.abspath(a), "b": os.path.abspath(b), **out}), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save", default=None, help="write each case's outputs here")
    ap.add_argument("--sass", action="store_true",
                    help="check K1-bf16's bf16x2 instructions; K1's and K2's splat loops")
    ap.add_argument("--paths", action="store_true",
                    help="the walk's paths at the benchmark cells' shapes")
    ap.add_argument("--rates", action="store_true", help="time the GA and Adam main paths")
    ap.add_argument("--compare", nargs=2, metavar=("OUT_A", "OUT_B"), default=None)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    return rates(args) if args.rates else times(args)


if __name__ == "__main__":
    sys.exit(main())
