#!/usr/bin/env python3
"""Device times of the port's gradient walks K6 (bwd_tiles) and K7
(lossgrad_tiles) in one checkout of this repository, for comparing two
commits on the same card.

    python3 tools/grad_walk_times.py [--tree DIR] [--reps N] [--save OUT]
    python3 tools/grad_walk_times.py --compare OUT_A OUT_B

DIR (default: this checkout) is the root of a checkout whose
ggs_tpu_torch package and chip_smoke.py are timed; its kernels are built
from its own sources. The shapes are chip_smoke.py's: K7 and K6 at
run_grad's default (B=1, N=2000, 512x512, the port's list tiles) and at the
memetic elite batch (B=8, N=512), and K6 with d(init) on the last chained
pass of grad-10k-1024 (B=1, N=10,000, 1024x1024). Each time is the mean of
CUDA events over N launches after a warm-up. Prints one JSON line with the
card's name and power limit as nvidia-smi gives them. Needs a CUDA card;
imports nothing of JAX.

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
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
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
    ms, hashes = {}, {}
    for key, (B, N, seed) in {"B1_N2000": (1, 2000, 10), "B8_N512": (8, 512, 11)}.items():
        c = cs.make_grad_case(B, N, 512, 512, seed=seed)
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
    ms["K6_grad_10k_1024_init"] = cs.cuda_ms(lambda: rg.bwd_tiles(*six, cs.BG, init=cg["init"]),
                                            max(1, args.reps // 2))
    hashes["K6_grad_10k_1024_init"] = cs.tensor_hash(*rg.bwd_tiles(*six, cs.BG, init=cg["init"]))
    del cg
    if args.save:
        hashes.update(entry_point_hashes(torch, cs, rg, codec, genome, io, g9, tgt))
        with open(args.save, "w") as fh:
            json.dump(hashes, fh)
    print(json.dumps({"tree": tree, "card": card, "device": torch.cuda.get_device_name(0),
                      "reps": args.reps, "ms": ms}), flush=True)
    return 0


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
