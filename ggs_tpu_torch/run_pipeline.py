"""The JAX package's measured-best fitting recipe as one command, in the port
(runners/run_pipeline.py):

    1. GA with error-guided splat growth (and recycling), via run_ga
    2. Adam polish of the evolved genome through the differentiable renderer,
       via run_grad --init-from ga_best_genome.npy

    python -m ggs_tpu_torch.run_pipeline --image photo \
        --n-splats 512 --ga-generations 100000 --adam-steps 800
"""
from __future__ import annotations

import argparse
import os

from . import run_ga, run_grad


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", default="imgs/reference.png")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--work-max-side", type=int, default=512)
    p.add_argument("--n-splats", type=int, default=512)
    p.add_argument("--pop-size", type=int, default=32)
    p.add_argument("--elite-k", type=int, default=8)
    p.add_argument("--ga-generations", type=int, default=100_000)
    p.add_argument(
        "--grow-mode", default="auto", choices=["auto", "stages"],
        help="auto (default): stall-triggered growth (run_ga --grow-auto); "
        "stages: the fixed --grow-stages plan",
    )
    p.add_argument("--grow-stages", type=int, default=4)
    p.add_argument("--grow-patience", type=int, default=1500)
    p.add_argument("--recycle-every", type=int, default=10_000)
    p.add_argument("--recycle-k", type=int, default=0, help="0 = n-splats/16")
    p.add_argument(
        "--recycle-patience", type=int, default=0,
        help="also recycle when the best fitness stalls this many generations "
        "(composes with --recycle-every)",
    )
    p.add_argument("--adam-steps", type=int, default=800)
    p.add_argument("--adam-lr", type=float, default=1e-2)
    p.add_argument("--metric", default="mse", choices=["mse", "ssim", "mix"],
                   help="objective for both stages: the GA selects and Adam polishes on it")
    p.add_argument("--ssim-weight", type=float, default=0.5)
    p.add_argument(
        "--precision", default="exact-tight",
        choices=["highest", "exact-tight", "fast", "bf16"],
        help="the GA stage's evaluation tier (the Adam polish always runs exact-tight)",
    )
    p.add_argument("--cull-eps", type=float, default=None,
                   help="the GA stage's fast-tier cull eps (default 2e-3)")
    p.add_argument("--memetic-every", type=int, default=0,
                   help="also interleave Adam steps on the elites during the GA stage")
    p.add_argument("--memetic-steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-video", action="store_true")
    p.add_argument("--impl", default="cuda", choices=["cuda", "oracle"])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Run both stages; returns {"ga": run_ga.main's result, "grad": run_grad.main's}."""
    args = build_parser().parse_args(argv)
    recycle_k = args.recycle_k or max(1, args.n_splats // 16)
    common = ["--image", args.image, "--output-dir", args.output_dir,
              "--work-max-side", str(args.work_max_side),
              "--n-splats", str(args.n_splats), "--seed", str(args.seed),
              "--metric", args.metric, "--ssim-weight", str(args.ssim_weight),
              "--impl", args.impl, "--device", args.device]

    print("=== stage 1/2: GA with error-guided growth ===", flush=True)
    ga_args = common + [
        "--pop-size", str(args.pop_size),
        "--elite-k", str(args.elite_k),
        "--generations", str(args.ga_generations),
        "--recycle-every", str(args.recycle_every),
        "--recycle-k", str(recycle_k),
        "--recycle-patience", str(args.recycle_patience),
        "--log-every", "1000",
        "--precision", args.precision,
    ]
    if args.cull_eps is not None:
        ga_args += ["--cull-eps", str(args.cull_eps)]
    if args.memetic_every > 0:
        ga_args += ["--memetic-every", str(args.memetic_every),
                    "--memetic-steps", str(args.memetic_steps)]
    if args.grow_mode == "auto":
        ga_args += ["--grow-auto", "--grow-patience", str(args.grow_patience)]
    else:
        ga_args += ["--grow-stages", str(args.grow_stages)]
    if args.no_video:
        ga_args.append("--no-video")
    ga_out = run_ga.main(ga_args)

    print("=== stage 2/2: Adam polish ===", flush=True)
    grad_out = run_grad.main(common + [
        "--init-from", os.path.join(args.output_dir, "ga_best_genome.npy"),
        "--steps", str(args.adam_steps),
        "--lr", str(args.adam_lr),
    ])
    print(
        "pipeline done: final image "
        f"{os.path.join(args.output_dir, 'grad_splats.png')}, genome "
        f"{os.path.join(args.output_dir, 'grad_genome.npy')}"
    )
    return {"ga": ga_out, "grad": grad_out}


if __name__ == "__main__":
    main()
