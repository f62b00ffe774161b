#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ggs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no exception is caught):
1. device: a CUDA card is required; prints nvidia-smi's name and power limit.
2. build: compiles csrc/walk.cu with nvcc for sm_90a; prints ptxas' report.
3. kernels: K1 (fitness_tiles) and K2 (render_tiles) against their plain
   PyTorch versions on bit-identical lists, at the GA main path's shapes
   (512x512, N=512, B=32, 64x128 tiles, exact-tight and highest), on an odd
   canvas, and with bin_capacity truncating the lists; plus the entry points
   on a small input against the dense oracle on the CPU.
4. main path: `python -m ggs_tpu_torch.run_ga` at its defaults (synthetic
   512x512 target, N=512, P=32, exact-tight) for GENERATIONS generations,
   with every launch count set to 0 before and read after: the best fitness
   must fall, K1 must launch at least once a generation, K2 for the export.
5. times: K1 at B=32 and B=512, K2 at B=1 and B=32, with CUDA events over
   many launches after a warm-up, their plain versions, the port's evaluate
   in renders/s at B=512 and the GA in generations/s over several blocks;
   each kernel's bound is computed from this run's lists.
6. profile: one GA block under torch.profiler, with the device time split
   between K1, sorting (the dense binning) and the other kernels.
Prints one `kernels` JSON line, the card line, and last the device line.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the GA main path's length; the launch check needs at least 100
GENERATIONS = 200
GA_BLOCKS, GA_BLOCK_GENS = 5, 100  # generations/s: timed blocks of the GA

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). The f32
# rate counts an FMA as 2 operations; the walk is built with -fmad=false,
# so the rate its one-operation instructions can reach is half of it.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 operations the walk in csrc/walk.cu executes, each counted as 1 and
# expf counted as 1 (the accurate expf is several instructions):
# per (splat, pixel) pair inside the box: 2 y compares, qy, qx*qy, nsxy*,
# +, qy*qy, nsyy*, +, exp, *a, 1-f, and 3 x (2 mul + 1 add) for the blend
OPS_PER_PAIR_PIXEL = 21
# per (splat, column) pair inside the box, hoisted out of the row loop:
# 2 x compares, qx, qx*qx, nsxx*
OPS_PER_PAIR_COLUMN = 5
# per pixel: K1 clamps (6), 3 sub, 3 squares, 2 add, *w, += (16); K2 clamps
OPS_PER_PIXEL_K1 = 16
OPS_PER_PIXEL_K2 = 6

CANVAS_ATOL = 2e-6
FITNESS_RTOL = 5e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms: CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_case(B, N, H, W, precision, cap=None, tile_h=64, tile_w=128, seed=0, device="cuda"):
    """Random population (seeded) -> the walk's inputs at these shapes."""
    import torch

    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, mask, render_cuda
    from ggs_tpu_torch.utils import io

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g9 = codec.genome_to_renderer(genome.new_population(gen, B, N, H, W, device=dev))
    cnt, idx, feats, n_tx, n_ty = render_cuda._prepare(
        g9, H, W, 3.0, precision, cap, tile_h, tile_w
    )
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device=dev)
    w = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
    tgt_p, w_p = render_cuda.pad_planes(tgt, w, n_ty * tile_h, n_tx * tile_w)
    return dict(cnt=cnt, idx=idx, feats=feats, tgt_p=tgt_p, w_p=w_p, n_tx=n_tx,
                tile_h=tile_h, tile_w=tile_w, g9=g9)


def pair_counts(c):
    """(pixels, columns) of the tile inside a listed splat's box, summed
    over every (candidate, tile, k < cnt): the walk's data-dependent work."""
    import torch

    cnt, idx, feats = c["cnt"], c["idx"], c["feats"]
    B, T, L = idx.shape
    n_tx, th, tw = c["n_tx"], c["tile_h"], c["tile_w"]
    boxes = torch.gather(
        feats[:, 9:13, :], 2, idx.long().reshape(B, 1, T * L).expand(B, 4, T * L)
    ).reshape(B, 4, T, L)
    t = torch.arange(T, device=idx.device)
    tx0 = ((t % n_tx) * tw).float()[None, :, None]
    ty0 = ((t // n_tx) * th).float()[None, :, None]
    wx = torch.minimum(boxes[:, 1], tx0 + tw - 1) - torch.maximum(boxes[:, 0], tx0) + 1
    hy = torch.minimum(boxes[:, 3], ty0 + th - 1) - torch.maximum(boxes[:, 2], ty0) + 1
    valid = torch.arange(L, device=idx.device)[None, None, :] < cnt[:, :, None]
    wx, hy = wx.clamp_min(0).double() * valid, hy.clamp_min(0).double()
    cols = wx * (hy > 0)
    return int((wx * hy).sum().item()), int(cols.sum().item())


def bound(c, kernel: str):
    """(bound_ms, bound_by) for one launch on these inputs: the larger of
    operations over peak f32 rate and bytes (inputs read once, outputs
    written once; only the cnt entries of each list) over memory rate."""
    B, T, _ = c["idx"].shape
    Hp, Wp = c["w_p"].shape
    n_list = int(c["cnt"].sum().item())
    pixels = B * Hp * Wp
    pair_px, pair_cols = pair_counts(c)
    walk_ops = pair_px * OPS_PER_PAIR_PIXEL + pair_cols * OPS_PER_PAIR_COLUMN
    in_bytes = 4 * (B * T + n_list + c["feats"].numel())
    if kernel == "K1":
        ops = walk_ops + pixels * OPS_PER_PIXEL_K1
        nbytes = in_bytes + 4 * (4 * Hp * Wp) + 4 * B * T
    else:
        ops = walk_ops + pixels * OPS_PER_PIXEL_K2
        nbytes = in_bytes + 4 * 3 * pixels
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def run_k1(c):
    from ggs_tpu_torch.ops import render_cuda as rc

    return rc.fitness_tiles(c["cnt"], c["idx"], c["feats"], c["tgt_p"], c["w_p"], c["n_tx"],
                            c["tile_h"], c["tile_w"], (1.0, 1.0, 1.0))


def run_k1_plain(c):
    from ggs_tpu_torch.ops import render_cuda as rc

    return rc.fitness_tiles_plain(c["cnt"], c["idx"], c["feats"], c["tgt_p"], c["w_p"],
                                  c["n_tx"], c["tile_h"], c["tile_w"], (1.0, 1.0, 1.0))


def run_k2(c):
    from ggs_tpu_torch.ops import render_cuda as rc

    return rc.render_tiles(c["cnt"], c["idx"], c["feats"], c["n_tx"], c["tile_h"],
                           c["tile_w"], (1.0, 1.0, 1.0))


def run_k2_plain(c):
    from ggs_tpu_torch.ops import render_cuda as rc

    Hp, Wp = c["w_p"].shape
    return rc.render_tiles_plain(c["cnt"], c["idx"], c["feats"], c["n_tx"], c["tile_h"],
                                 c["tile_w"], (1.0, 1.0, 1.0), Hp, Wp)


def compare(c, label: str) -> dict:
    """K1 and K2 against their plain versions on the same lists."""
    import torch

    k2, p2 = run_k2(c), run_k2_plain(c)
    k1, p1 = run_k1(c), run_k1_plain(c)
    torch.cuda.synchronize()
    canvas_err = float((k2 - p2).abs().max())
    f_k, f_p = k1.sum(1).double(), p1.sum(1).double()
    fit_rel = float(((f_k - f_p).abs() / f_p.abs().clamp_min(1e-30)).max())
    part_err = float((k1 - p1).abs().max())
    again = run_k1(c)
    print(f"CHECK {label}: K2 canvas max abs {canvas_err:.3e} (<= {CANVAS_ATOL}), "
          f"K1 fitness max rel {fit_rel:.3e} (<= {FITNESS_RTOL}), K1 partials max abs "
          f"{part_err:.3e}, max cnt {int(c['cnt'].max())}", flush=True)
    check(canvas_err <= CANVAS_ATOL, f"{label}: K2 canvas differs by {canvas_err}")
    check(fit_rel <= FITNESS_RTOL, f"{label}: K1 fitness differs by {fit_rel}")
    check(torch.equal(again, k1), f"{label}: K1 is not the same bits on a second launch")
    return {"canvas": canvas_err, "fitness_rel": fit_rel, "partials": part_err}


def profile_split(fn, n_gens: int) -> dict:
    """Device time of one fn() (n_gens GA generations) under torch.profiler,
    split between K1, sort kernels (the dense binning) and the rest, with
    the device's busy share of the host-timed window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    split = {"K1": 0.0, "sort": 0.0, "other": 0.0}
    by_name = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        key = ("K1" if "fitness_kernel" in e.key
               else "sort" if "sort" in e.key.lower() or "radix" in e.key.lower() else "other")
        split[key] += us / 1e3
        by_name.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(split.values())
    by_name.sort(reverse=True)
    return {
        "generations": n_gens,
        "wall_ms_under_profiler": wall_ms,
        "device_ms": split,
        "device_busy_share": busy / wall_ms,
        "kernels_per_generation": sum(n for _, n, _ in by_name) / n_gens,
        "top": [{"ms": ms, "count": n, "name": k} for ms, n, k in by_name[:8]],
    }


def main() -> int:
    import torch

    # 1. device
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ggs_tpu_torch import run_ga
    from ggs_tpu_torch.config import GAConfig, GenomeConfig, MaskConfig
    from ggs_tpu_torch.models import ga, genome
    from ggs_tpu_torch.ops import codec, mask, objective, oracle, render_cuda as rc
    from ggs_tpu_torch.utils import io

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(card, flush=True)

    # 2. build
    phase("build")
    t0 = time.perf_counter()
    kern = rc.build()
    print(f"built {os.path.relpath(kern.path, HERE)} in {time.perf_counter() - t0:.2f} s")
    for line in kern.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    # 3. kernels against their plain versions
    phase("kernels vs plain")
    errs = {}
    main_case = {}
    for precision in ("exact-tight", "highest"):
        c = make_case(32, 512, 512, 512, precision)
        errs[precision] = compare(c, f"B=32 N=512 512x512 {precision}")
        main_case[precision] = c
    c_odd = make_case(4, 256, 200, 328, "exact-tight", seed=1)
    compare(c_odd, "B=4 N=256 200x328 exact-tight (odd canvas)")
    cap = int(c_odd["cnt"].max()) // 2
    c_cap = make_case(4, 256, 200, 328, "highest", cap=cap, seed=1)
    check(int(c_cap["cnt"].max()) == cap, "bin_capacity did not truncate")
    compare(c_cap, f"B=4 N=256 200x328 highest bin_capacity={cap}")

    # the entry points on a small input against the dense oracle on the CPU
    gen = torch.Generator(device="cuda").manual_seed(7)
    g_small = genome.new_population(gen, 2, 16, 40, 200, min_scale=1.0, max_scale=0.3,
                                    device="cuda")
    tgt_small = io.ensure_hw(io.synthetic_target(40, 200), 40, 200, device="cuda")
    obj_small = objective.Objective(H=40, W=200, precision="exact-tight")
    f_gpu = objective.evaluate(obj_small, g_small, tgt_small, device="cuda").double().cpu()
    f_ref = objective.evaluate(obj_small._replace(impl="oracle"), g_small.cpu(),
                               tgt_small.cpu(), device="cpu").double()
    rel = float(((f_gpu - f_ref).abs() / f_ref).max())
    img_gpu = objective.render_genomes(obj_small, g_small, device="cuda").cpu()
    img_ref = oracle.render_dense(codec.genome_to_renderer(g_small.cpu()), 40, 200, box="tight")
    img_err = float((img_gpu - img_ref).abs().max())
    print(f"CHECK entry points vs CPU dense oracle (B=2 N=16 40x200): fitness max rel "
          f"{rel:.3e}, canvas max abs {img_err:.3e}")
    check(rel <= FITNESS_RTOL and img_err <= CANVAS_ATOL, "entry points disagree with the oracle")

    # 4. the main path
    phase("main path")
    out_dir = os.path.join(HERE, "output", "chip_smoke")
    rc.fitness_tiles.launches = 0
    rc.render_tiles.launches = 0
    t0 = time.perf_counter()
    res = run_ga.main([
        "--image", "synthetic", "--generations", str(GENERATIONS), "--log-every", "50",
        "--no-video", "--output-dir", out_dir, "--device", "cuda",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": rc.fitness_tiles.launches, "K2": rc.render_tiles.launches}
    best = res["curves"]["best"]
    final = res["final"]
    summary = {
        "generations": GENERATIONS, "seconds": wall, "best_first": best[0],
        "best_last": best[-1], "exact_rescore": res["best_fit"], "launches": launches,
    }
    print("MAIN PATH " + json.dumps(summary), flush=True)
    check(len(best) == GENERATIONS + 1, "curve length")
    check(best[-1] < best[0], f"best fitness did not fall ({best[0]} -> {best[-1]})")
    check(math.isfinite(res["best_fit"]) and res["best_fit"] > 0, "rescored fitness")
    check(tuple(final.shape) == (512, 512, 3) and bool(torch.isfinite(final).all())
          and float(final.min()) >= 0.0 and float(final.max()) <= 1.0, "final render")
    check(launches["K1"] >= GENERATIONS, f"K1 launched {launches['K1']} times")
    check(launches["K2"] >= 1, "K2 was not launched by the export render")

    # 5. times
    phase("times")
    c32 = main_case["exact-tight"]
    c512 = make_case(512, 512, 512, 512, "exact-tight", seed=2)
    c1 = make_case(1, 512, 512, 512, "exact-tight", seed=3)
    t = {
        "K1_B32": cuda_ms(lambda: run_k1(c32), 50),
        "K1_B512": cuda_ms(lambda: run_k1(c512), 10),
        "K2_B1": cuda_ms(lambda: run_k2(c1), 100),
        "K2_B32": cuda_ms(lambda: run_k2(c32), 50),
        "K1_plain_B32": cuda_ms(lambda: run_k1_plain(c32), 3, warmup=1),
        "K1_plain_B512": cuda_ms(lambda: run_k1_plain(c512), 1, warmup=1),
        "K2_plain_B1": cuda_ms(lambda: run_k2_plain(c1), 5, warmup=1),
        "K2_plain_B32": cuda_ms(lambda: run_k2_plain(c32), 3, warmup=1),
    }
    bounds = {
        "K1_B32": bound(c32, "K1"), "K1_B512": bound(c512, "K1"),
        "K2_B1": bound(c1, "K2"), "K2_B32": bound(c32, "K2"),
    }
    del c512

    # evaluate() end to end (codec, boxes, binning, K1) at bench.py's batch
    H = W = 512
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device="cuda")
    wm = mask.mask_from_config(tgt, H, W, MaskConfig())
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    gen = torch.Generator(device="cuda").manual_seed(5)
    pop512 = genome.new_population(gen, 512, 512, H, W, device="cuda")
    eval_ms = cuda_ms(lambda: objective.evaluate(obj, pop512, tgt, wm), 10)
    renders_per_s = 512 / (eval_ms / 1e3)
    del pop512

    # GA generations/s at the main path's configuration, host-timed per block
    cfg = GAConfig(pop_size=32, generations=500_000)
    gnm = GenomeConfig(n_splats=512)
    st = ga.init(torch.Generator(device="cuda").manual_seed(9), obj, tgt, wm, cfg, gnm)
    st, _ = ga.run_block(st, obj, tgt, wm, cfg, gnm, 20)
    torch.cuda.synchronize()
    block_rates = []
    for _ in range(GA_BLOCKS):
        t0 = time.perf_counter()
        st, m = ga.run_block(st, obj, tgt, wm, cfg, gnm, GA_BLOCK_GENS)
        m.cpu()
        torch.cuda.synchronize()
        block_rates.append(GA_BLOCK_GENS / (time.perf_counter() - t0))
    gens_per_s = sorted(block_rates)[GA_BLOCKS // 2]

    times = {
        "card": card,
        "ms": t,
        "bound_ms": {k: v[0] for k, v in bounds.items()},
        "bound_by": {k: v[1] for k, v in bounds.items()},
        "evaluate_B512_exact_tight_ms": eval_ms,
        "renders_per_s_B512": renders_per_s,
        "ga_generations_per_s_P32_N512_512x512_exact_tight": gens_per_s,
        "ga_generations_per_s_blocks": block_rates,
        "sum_cnt": {"B32": int(c32["cnt"].sum()), "B1": int(c1["cnt"].sum())},
    }
    print("TIMES " + json.dumps(times), flush=True)

    # 6. profile
    phase("profile")
    prof = profile_split(lambda: ga.run_block(st, obj, tgt, wm, cfg, gnm, 20)[1].cpu(), 20)
    print("PROFILE " + json.dumps(prof), flush=True)

    kernels = [
        {
            "name": "K1 fitness_tiles (fused walk + weighted SSE partials)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/walk.cu",
            "replaces": "ggs_tpu/ops/render_pallas.py:1460",
            "launches": launches["K1"],
            "max_abs_err": errs["exact-tight"]["partials"],
            "ms": t["K1_B32"],
            "plain_ms": t["K1_plain_B32"],
            "bound_ms": bounds["K1_B32"][0],
            "bound_by": bounds["K1_B32"][1],
            "library_ms": None,
        },
        {
            "name": "K2 render_tiles (walk + clamped canvas)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/walk.cu",
            "replaces": "ggs_tpu/ops/render_pallas.py:118",
            "launches": launches["K2"],
            "max_abs_err": errs["exact-tight"]["canvas"],
            "ms": t["K2_B1"],
            "plain_ms": t["K2_plain_B1"],
            "bound_ms": bounds["K2_B1"][0],
            "bound_by": bounds["K2_B1"][1],
            "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
