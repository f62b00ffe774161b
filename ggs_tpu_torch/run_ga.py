"""GA entry point of the port (runners/run_ga.py, for what the port supports).

Loads a target image, picks the working resolution, runs the GA on the
card, rescores the winner on the exact energy, and exports the
full-resolution render and the loss curves.

    python -m ggs_tpu_torch.run_ga --image synthetic --generations 5000 --no-video

`--precision fast` scores with the fast tier (K4 table and eps-tight boxes,
corner-culled lists, the K3 exp2 walk) at `--cull-eps` (default 2e-3);
`--precision bf16` with the bf16 walk (K1-bf16); either way the winner is
rescored on the exact "highest" energy. Options of runners/run_ga.py that
are not ported yet (meshes, islands, annealing, recycling, growth,
progressive stages, checkpoints, video frames) are not accepted; the
SSIM/mix metrics raise NotImplementedError. `--memetic-every E` gives the
elites `--memetic-steps` Adam steps every E generations (the K7 kernel,
over the eps-culled lists under "fast"; refused under "bf16").
"""
from __future__ import annotations

import argparse
import math
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", default="imgs/reference.png",
                   help="image path, or 'synthetic[:HxW]' for the procedural target")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--work-max-side", type=int, default=512)
    p.add_argument("--n-splats", type=int, default=512)
    p.add_argument("--pop-size", type=int, default=32)
    p.add_argument("--generations", type=int, default=500_000)
    p.add_argument("--tour-k", type=int, default=2)
    p.add_argument("--elite-k", type=int, default=8)
    p.add_argument("--cxpb", type=float, default=0.05)
    p.add_argument("--mutpb", type=float, default=0.05)
    p.add_argument("--schedule", default="cosine", choices=["cosine", "linear", "exp"])
    p.add_argument("--k-sigma", type=float, default=3.0)
    p.add_argument("--mask-strength", type=float, default=0.7)
    p.add_argument("--boost-only", action="store_true")
    p.add_argument("--impl", default="cuda", choices=["cuda", "oracle"])
    p.add_argument(
        "--precision", default="exact-tight",
        choices=["highest", "exact-tight", "fast", "bf16"],
        help="exact-tight (default): the exact f32 walk over the tight k-sigma "
        "box; highest: the reference's conservative box; fast: the exp2 walk "
        "over eps-culled boxes and lists (--cull-eps); bf16: the exact walk in "
        "bf16 (fitness only)",
    )
    p.add_argument(
        "--cull-eps", type=float, default=None,
        help="fast tier: the splat-contribution cull eps (default 2e-3); 8e-2 is "
        "the largest value the JAX package validated as selection-safe",
    )
    p.add_argument("--metric", default="mse", choices=["mse", "ssim", "mix"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--no-video", action="store_true",
                   help="required: the port writes no video frames yet")
    p.add_argument("--eval-chunk", type=int, default=0, help="0 = whole population at once")
    p.add_argument(
        "--memetic-every", type=int, default=0,
        help="hybrid GA+Adam: every N generations give the elites --memetic-steps "
        "Adam steps through the differentiable renderer, each kept only when it "
        "improved on the GA's own energy (0 = off)",
    )
    p.add_argument("--memetic-steps", type=int, default=5)
    p.add_argument("--memetic-lr", type=float, default=1e-2)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Run the GA; returns {"best_fit", "curves", "final" (the export render), "best"}."""
    args = build_parser().parse_args(argv)
    if not args.no_video:
        raise NotImplementedError("video frames are not ported yet; pass --no-video")

    import numpy as np
    import torch

    from . import resolve_device
    from .config import GAConfig, GenomeConfig, MaskConfig
    from .models import ga
    from .ops import codec, mask as mask_mod, objective, render
    from .utils import io as io_mod

    dev = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    target = io_mod.load_image(args.image)
    H_out, W_out = target.shape[0], target.shape[1]
    H, W = codec.choose_work_size(H_out, W_out, max_side=args.work_max_side)
    print(f"target {H_out}x{W_out} -> work {H}x{W} on {dev}")

    obj = objective.Objective(
        H=H, W=W, k_sigma=args.k_sigma, boost_only=args.boost_only, impl=args.impl,
        chunk=args.eval_chunk or None, metric=args.metric, precision=args.precision,
        cull_eps=args.cull_eps,
    )
    ga_cfg = GAConfig(
        pop_size=args.pop_size, generations=args.generations, tour_k=args.tour_k,
        elite_k=args.elite_k, cxpb=args.cxpb, mutpb=args.mutpb, schedule=args.schedule,
    )
    gnm = GenomeConfig(n_splats=args.n_splats)
    mask_cfg = MaskConfig(strength=args.mask_strength, boost_only=args.boost_only)
    best, best_fit, curves = ga.genetic_approx(
        target, H, W, obj=obj, ga=ga_cfg, gnm=gnm, mask_cfg=mask_cfg, seed=args.seed,
        log_every=args.log_every,
        loss_png_path=os.path.join(args.output_dir, "ga_loss.png"),
        loss_csv_path=os.path.join(args.output_dir, "ga_loss.csv"), device=dev,
        memetic_every=args.memetic_every, memetic_steps=args.memetic_steps,
        memetic_lr=args.memetic_lr,
    )
    label = "MSE" if args.metric == "mse" else f"energy ({args.metric})"
    if args.precision != "highest":
        # rescore the winner on the exact energy so the number reported is
        # independent of the evaluation tier
        t_work = io_mod.ensure_hw(target, H, W, device=dev)
        wm = mask_mod.mask_from_config(t_work, H, W, mask_cfg)
        best_fit = float(
            objective.evaluate(
                obj._replace(precision="highest", cull_eps=None), best[None], t_work, wm,
                device=dev,
            )[0]
        )
        print(f"Best {label} (exact rescore):", best_fit)
    else:
        print(f"Best {label}:", best_fit)
    if best_fit > 0 and args.metric == "mse":
        print(f"PSNR: {-10.0 * math.log10(best_fit):.2f} dB")

    # full-resolution export (run_ggs.py:64-77): rescale the genome, render once
    best_t = torch.as_tensor(best, device=dev)
    best_full = codec.scale_genome_pixels_anisotropic(best_t, sH=H_out / float(H), sW=W_out / float(W))
    g9 = codec.genome_to_renderer(best_full)
    final = render.render_splats(g9[None], H_out, W_out, k_sigma=args.k_sigma, impl=args.impl)[0]
    out_path = os.path.join(args.output_dir, "ga_splats.png")
    io_mod.save_image_u8(final, out_path)
    np.save(os.path.join(args.output_dir, "ga_best_genome.npy"), best)
    print(f"Saved full resolution result as {out_path}")
    return {"best_fit": best_fit, "curves": curves, "final": final, "best": best}


if __name__ == "__main__":
    main()
