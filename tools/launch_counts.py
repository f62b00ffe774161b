#!/usr/bin/env python3
"""Device launches of the port's host-bound blocks, counted two ways: as the
nodes of a CUDA graph that captures the block (kernels, copies and fills,
exact by construction: chip_smoke.graph_launches) and by torch.profiler
sessions of the same block (chip_smoke's earlier reading), repeated.

    python3 tools/launch_counts.py [--sessions N] [--gens G]

The blocks are chip_smoke.py's: a GA block at run_ga's defaults (512x512,
N=512, population 32, importance mask) under exact-tight and under fast, an
annealed GA block (sigma 8), an island GA block (4 islands, migration every
generation) and an Adam block at run_grad's defaults (N=2000). Each block
is counted from a state of its own, and each profiler session runs the
block on the state the previous one left. Per block it prints the graph's
count a step, each session's count a step, and the kernel names whose
count differs between sessions, so a session that lost records shows as a
name whose count falls short of the others' (and of the graph's total)
while the code is the same.
Prints one JSON line with the card's name and power limit as nvidia-smi
gives them. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiler_counts(fn) -> collections.Counter:
    """Device records by name (kernels, copies, fills) of one fn() under
    torch.profiler, as chip_smoke.profile_split counts them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            out[e.key[:90]] += e.count
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sessions", type=int, default=5)
    ap.add_argument("--gens", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("launch_counts: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig, MaskConfig
    from ggs_tpu_torch.models import ga, genome, gradient
    from ggs_tpu_torch.ops import anneal, objective, render_cuda as rc
    from ggs_tpu_torch.ops import mask
    from ggs_tpu_torch.parallel import island
    from ggs_tpu_torch.utils import io

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    rc.build()
    H = W = 512
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device="cuda")
    wm = mask.mask_from_config(tgt, H, W, MaskConfig())
    cfg, gnm = GAConfig(pop_size=32, generations=500_000), GenomeConfig(n_splats=512)
    exact = objective.Objective(H=H, W=W, precision="exact-tight")
    fast = objective.Objective(H=H, W=W, precision="fast")
    sig = torch.full((), 8.0, dtype=torch.float32, device="cuda")
    tgt_b = anneal.blur_image(tgt, sig, anneal.default_radius(8.0))
    n = args.gens

    def ga_block(obj, seed, target=tgt, blur=None, islands=0):
        box = {"st": ga.init(torch.Generator(device="cuda").manual_seed(seed), obj, tgt, wm, cfg,
                             gnm)}
        run = (island.make_run_block(obj, cfg, gnm, islands, migrate_every=1, migrate_k=2)
               if islands else None)

        def fn():
            if run is None:
                box["st"], m = ga.run_block(box["st"], obj, target, wm, cfg, gnm, n,
                                            blur_sigma=blur)
            else:
                box["st"], m = run(box["st"], target, wm, n)
            return m
        return fn, box

    def adam_block(seed):
        make_opt, step = gradient.make_fit_step(exact, GenomeConfig(n_splats=2000),
                                                GradConfig(lr=1e-2))
        g0 = genome.new_population(torch.Generator(device="cuda").manual_seed(seed), 1, 2000, H,
                                   W, device="cuda")
        box = {"st": gradient.init_state(make_opt, g0)}

        def fn():
            box["st"], f = gradient.run_block(box["st"], step, tgt, wm, n)
            return f
        return fn, box

    blocks = {
        "ga_exact_tight": lambda s: ga_block(exact, s),
        "ga_fast": lambda s: ga_block(fast, s),
        "ga_annealed": lambda s: ga_block(exact, s, tgt_b, sig),
        "ga_islands_4": lambda s: ga_block(exact, s, islands=4),
        "adam": adam_block,
    }
    out = {"card": card, "steps": n, "sessions": args.sessions, "blocks": {}}
    for name, make in blocks.items():
        fn, box = make(70)
        st = box["st"]
        graph = cs.graph_launches(fn, n, generators=[st.rng] if hasattr(st, "rng") else [],
                                  optimizers=[st.opt] if hasattr(st, "opt") else [])
        fn, box = make(71)
        fn()  # warm-up
        sessions = [profiler_counts(fn) for _ in range(args.sessions)]
        totals = [sum(c.values()) for c in sessions]
        names = sorted(set().union(*sessions))
        differ = {k: [c[k] for c in sessions] for k in names
                  if len({c[k] for c in sessions}) > 1}
        rec = {"graph_per_step": graph["per_step"], "graph_nodes": graph["nodes"],
               "profiler_per_step": [t / n for t in totals],
               "profiler_names_that_differ": differ}
        out["blocks"][name] = rec
        print(f"LAUNCH COUNTS {name} " + json.dumps(rec), flush=True)
    print(json.dumps({k: ({b: {"graph": r["graph_per_step"], "profiler": r["profiler_per_step"]}
                           for b, r in v.items()} if k == "blocks" else v)
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
