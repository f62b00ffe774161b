#!/usr/bin/env python3
"""Device times of the port's scatter binning (K5, csrc/scatter.cu, with
whatever else its route runs) and of K4 (prep_fast, csrc/walk.cu) in one
checkout of this repository, and canvas-4k's renders/s in its three tiers,
for comparing two commits on the same card; and a comparison of two
checkouts' outputs.

    python3 tools/scatter_times.py [--tree DIR] [--save OUT]
    python3 tools/scatter_times.py --compare OUT_A OUT_B

DIR (default: this checkout) is the root of a checkout whose
ggs_tpu_torch package and chip_smoke.py are timed; its kernels are built
from its own sources (a checkout whose render path has ops/screen.py and
profiling.COUNTS; time an older one with its own copy of this script). The
binning route is `render_cuda.bin_splats` from the pixel boxes (and the corner parameters) to the lists, on
chip_smoke.py's cases, made from its seeds: the first 5,000-splat pass of
the 2048x2048 GA (B=32, 512 tiles; exact-tight, and fast at eps 2e-3 with
the corner cull, where the batch overflows cap_s and the fallback rebuilds
the lists), the first pass of canvas-4k (B=1, 7,142 splats, 2,048 tiles;
"highest", and fast at eps 8e-2 with the corner cull), and of grad-10k-1024
(B=1, 5,000 splats, 512 16x128 tiles, exact-tight). For each: "ms", the
mean of CUDA events over many calls after a warm-up; "device_ms", the sum
of every kernel's device time a call under torch.profiler; "launches", the
kernels a call launches; and "bound_ms" (by bytes or operations), the least
time of the function on an H100 SXM by this checkout's
chip_smoke.scatter_bound, whichever tree is timed. K4 at B=32 and B=512
(N=512, 512x512, eps 2e-3): CUDA events and its device time, beside the
device time of an empty kernel (the launch floor; only where the tree's
library has one). Canvas-4k (N=50,000, 4096x4096, seven passes):
renders/s by CUDA events over 3 renders in each tier (exact "highest",
fast, fast with the corner cull) and, under the profiler, its kernels a
render and the card's busy share. The benchmark cells' binning shapes
("cells"), exact-tight, each the first pass of a seeded population
(`genome.new_population`): the flagship's (B=1024, 1024x1024, 128 64x128
tiles, 5,000 of 10,000 splats), the photo's (384x512, 24 64x128 tiles,
N=512) at B=32 and B=512, and run_grad's (B=1, 96 16x128 tiles, N=2000):
the dense route (`bin_splats_dense`), K5 (`bin_splats_scatter`) and the
tree's own `bin_splats`, each by CUDA events and its device time, whether
K5's lists equal the dense ones as integers, and the calls by route that
`bin_splats` counts (where the tree counts them). Prints one JSON line
with the card's name and power limit as nvidia-smi gives them. Needs a
CUDA card; imports nothing of JAX.

With --save OUT it also writes a hash of each case's lists (idx, cnt), of
each cell's lists as the tree's `bin_splats` and as the dense route give
them, and of K4's outputs (ff, fi) into OUT (a JSON file). --compare reads
two such files (needs no card), prints one JSON line saying which are
equal, and exits 1 where any differs.

To compare a parent commit with a change, unpack the parent (`git archive`)
into a directory that .gitignore lists and run, in one call on one card,
parent, change, change, parent, saving the first two.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile(fn, n: int, torch) -> dict:
    """Under torch.profiler: the device time of every kernel a call of fn,
    the kernels a call, and each kernel's device time a call by name."""
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
    out = {"device_ms": 0.0, "launches": 0.0, "by_kernel": {}}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        t = getattr(e, "self_device_time_total", None)
        ms = (e.self_cuda_time_total if t is None else t) / 1e3 / n
        out["device_ms"] += ms
        out["launches"] += e.count / n
        out["by_kernel"][e.key[:60]] = ms
    return out


def _hash(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# the benchmark cells' binning shapes: (B, N, H, W, tile_h, pass splats)
CELLS = {
    "flagship_p4096": (1024, 10_000, 1024, 1024, 64, 5_000),  # ga1024-p4096's passes
    "photo_p32": (32, 512, 384, 512, 64, 512),  # ga512-p32
    "photo_p512": (512, 512, 384, 512, 64, 512),  # ga512-p512
    "grad_photo": (1, 2000, 384, 512, 16, 2000),  # adam512-n2000 (run_grad's tile)
}


def _route_counts() -> dict:
    """bin_splats' calls by route."""
    from ggs_tpu_torch.utils import profiling

    return {k: profiling.COUNTS[k] for k in ("bin.dense", "bin.k5")}


def cell_times(torch, cs, rc, rg, hashes: dict) -> dict:
    """The dense route, K5 and the tree's bin_splats at each of CELLS."""
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, screen

    out = {}
    for name, (B, N, H, W, th, n) in CELLS.items():
        gen = torch.Generator(device="cuda").manual_seed(40)
        g9 = codec.genome_to_renderer(genome.new_population(gen, B, N, H, W, device="cuda"))
        p = rc._split_screen(screen.screen(g9, H, W, 3.0, screen.tier("exact-tight")), 0, n)
        del g9
        pad = rg.GRAD_SCATTER_PAD if th == rg.GRAD_TILE_H else rc.SCATTER_PAD
        geo = (-(-W // 128), -(-H // th), th, 128, n)
        box = (p.x0, p.x1, p.y0, p.y1)
        plan = rc._scatter_plan(*geo[:2], n, n, pad, None)
        fns = {
            "dense": lambda: rc.bin_splats_dense(*box, *geo),
            "k5": lambda: rc.bin_splats_scatter(*box, *geo, pad)[:2],
            "bin_splats": lambda: rc.bin_splats(*box, *geo, None, pad_slots=pad),
        }
        dense = fns["dense"]()
        hashes[f"cell_dense_{name}"] = _hash(*dense)
        k5 = fns["k5"]()
        equal = torch.equal(k5[0], dense[0]) and torch.equal(k5[1], dense[1])
        before = _route_counts()
        routed = fns["bin_splats"]()
        hashes[f"cell_lists_{name}"] = _hash(*routed)
        took = {k: v - before[k] for k, v in _route_counts().items()}
        row = {"B": B, "tiles": geo[0] * geo[1], "n": n, "rpg": plan.rpg if plan else None,
               "pairs": int(dense[1].sum()), "max_count": int(dense[1].max()),
               "k5_equals_dense": equal, "bin_splats_route": took}
        del dense, k5, routed
        reps = 5 if B >= 1024 else 50
        for key, fn in fns.items():
            prof = _profile(fn, 2 if B >= 1024 else 10, torch)
            row[key] = {"ms": cs.cuda_ms(fn, reps), "device_ms": prof["device_ms"],
                        "launches": prof["launches"]}
        out[name] = row
        del p, box, fns
        torch.cuda.empty_cache()
    return out


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def times(tree: str, save: str | None) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs  # the tree's own cases and seeds
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, render_cuda as rc
    from ggs_tpu_torch.ops import render_grad as rg

    here = _load("chip_smoke_bounds", os.path.join(HERE, "chip_smoke.py"))  # the bound
    if not torch.cuda.is_available():
        raise SystemExit("scatter_times: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    kern = rc.build()
    chunk = cs.BIG_N // 2
    cases = {
        "ga_exact": cs.scatter_case(cs.GA_P, cs.BIG_N, cs.GA_SIDE, 64, "exact-tight", chunk=chunk,
                                    seed=30),
        "ga_fast": cs.scatter_case(cs.GA_P, cs.BIG_N, cs.GA_SIDE, 64, "fast", 2e-3, chunk=chunk,
                                   seed=30),
        "c4k_exact": cs.scatter_case(1, cs.C4K_N, cs.C4K_SIDE, 64, "highest", chunk=cs.C4K_N // 7,
                                     scales=cs.C4K_SCALES, seed=31),
        "c4k_fast": cs.scatter_case(1, cs.C4K_N, cs.C4K_SIDE, 64, "fast", cs.C4K_EPS,
                                    chunk=cs.C4K_N // 7, scales=cs.C4K_SCALES, seed=31),
        "grad_1024": cs.scatter_case(1, cs.BIG_N, cs.BIG_SIDE, rg.GRAD_TILE_H, "exact-tight",
                                     chunk=chunk, seed=32, pad_slots=rg.GRAD_SCATTER_PAD),
    }
    out = {"tree": tree, "card": card, "routes": {}, "k4": {}, "canvas_4k": {}}
    hashes = {}
    out["cells"] = cell_times(torch, cs, rc, rg, hashes)
    for name, sc in cases.items():
        p, corner = sc["p"], sc["corner"]
        side = cs.C4K_SIDE if name.startswith("c4k") else (cs.GA_SIDE if name.startswith("ga")
                                                             else cs.BIG_SIDE)
        th = rg.GRAD_TILE_H if name == "grad_1024" else 64
        pad = rg.GRAD_SCATTER_PAD if name == "grad_1024" else rc.SCATTER_PAD
        geo = (-(-side // 128), -(-side // th), th, 128, p.cx.shape[1])

        def route(p=p, geo=geo, corner=corner, pad=pad):
            return rc.bin_splats(p.x0, p.x1, p.y0, p.y1, *geo, corner, pad_slots=pad)

        idx, cnt = route()
        hashes[f"lists_{name}"] = _hash(idx, cnt)
        reps = 20 if name.startswith("ga") else 50
        prof = _profile(route, 5, torch)
        args = rc.scatter_args(p.x0, p.x1, p.y0, p.y1, *geo, pad, corner=corner)
        overflow = (args["fallback"] is not None
                    and int(rc.bin_splats_scatter_plain(**args)[2]) > args["cap_s"])
        bound = here.scatter_bound(p.x0, p.x1, p.y0, p.y1, *geo, args["rpg"],
                                   corner if args["cxr"] is not None else None, overflow)
        out["routes"][name] = {
            "ms": cs.cuda_ms(route, reps), "device_ms": prof["device_ms"],
            "launches": prof["launches"], "bound_ms": bound[0], "bound_by": bound[1],
            "overflow": overflow, "pairs": int(cnt.sum()), "by_kernel": prof["by_kernel"],
        }
        del idx, cnt
    del cases
    torch.cuda.empty_cache()

    for B in (32, 512):
        gen = torch.Generator(device="cuda").manual_seed(20)
        g9 = codec.genome_to_renderer(genome.new_population(gen, B, 512, 512, 512, device="cuda"))
        g9 = g9.contiguous()

        def k4(g9=g9):
            return rc.prep_fast(g9, 512, 512, 3.0, 2e-3)

        hashes[f"k4_B{B}"] = _hash(*k4())
        prof = _profile(k4, 50, torch)
        out["k4"][f"B{B}"] = {
            "ms": cs.cuda_ms(k4, 200), "launches": prof["launches"],
            "device_ms": sum(v for k, v in prof["by_kernel"].items() if "prep_fast" in k),
            "bound_ms": cs.k4_bound(B, 512)[0],
        }
    if hasattr(kern.lib, "ggs_empty_launch"):  # the launch floor
        def empty():
            kern.check(kern.lib.ggs_empty_launch(torch.cuda.current_stream().cuda_stream),
                       "empty kernel")

        out["k4"]["empty_kernel_device_ms"] = _profile(empty, 200, torch)["device_ms"]
        out["k4"]["empty_kernel_ms"] = cs.cuda_ms(empty, 200)

    gen = torch.Generator(device="cuda").manual_seed(35)  # chip_smoke's canvas-4k population
    g9 = codec.genome_to_renderer(genome.new_population(gen, 1, cs.C4K_N, cs.C4K_SIDE, cs.C4K_SIDE,
                                                        *cs.C4K_SCALES, device="cuda"))
    tiers = {"exact": dict(precision="highest"),
             "fast": dict(precision="fast", cull_eps=cs.C4K_EPS),
             "fast+corner": dict(precision="fast", cull_eps=cs.C4K_EPS, corner_cull=True)}
    for tier, kw in tiers.items():
        def render(kw=kw):
            return rc.render(g9, cs.C4K_SIDE, cs.C4K_SIDE, **kw)

        hashes[f"c4k_{tier}"] = _hash(render())
        prof = cs.profile_split(render, 1, walk="render_kernel")
        out["canvas_4k"][tier] = {
            "renders_per_s": 1e3 / cs.cuda_ms(render, 3, warmup=1),
            "launches": prof["kernels_per_step"], "device_busy_share": prof["device_busy_share"],
            "device_ms": prof["device_ms"],
        }
    if save:
        with open(save, "w") as fh:
            json.dump(hashes, fh)
    return out


def compare(a: str, b: str) -> int:
    with open(a) as fh:
        ha = json.load(fh)
    with open(b) as fh:
        hb = json.load(fh)
    same = {k: ha.get(k) == hb.get(k) for k in sorted(set(ha) | set(hb))}
    print(json.dumps({"same": same}))
    return 0 if all(same.values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2, metavar=("OUT_A", "OUT_B"))
    a = ap.parse_args(argv)
    if a.compare:
        return compare(*a.compare)
    print(json.dumps(times(a.tree, a.save)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
