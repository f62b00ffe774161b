"""SA entry point of the port (runners/run_sa.py, for what the port supports).

Loads a target image, picks the working resolution, runs simulated
annealing on the card, rescores the winner on the exact energy, and
exports the full-resolution render, the genome, the curves, the video
frames and their animation (`sa_anim.apng`; `--no-video` turns them off).

    python -m ggs_tpu_torch.run_sa --image synthetic --iterations 5000

`--proposal-mode batched` (default) scores all tries of an iteration as
one batch; `sequential` chains each try on the updated state with batch-1
renders. `--replicas K` runs parallel tempering: K chains on a geometric
ladder to `--t-hot`, tries x K proposals scored as one batch, neighbour
swaps every `--swap-every` iterations. `--metric ssim|mix` scores rendered
canvases with the SSIM energy (`--ssim-weight` for mix). Under any tier but
"highest" the winner is rescored on the exact "highest" energy.
`--checkpoint-every K` saves `output_dir/sa_ckpt.npz` every K iterations
and `--resume PATH` continues from such a file, bit for bit.
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
    p.add_argument("--iterations", type=int, default=500_000)
    p.add_argument("--tries-per-iter", type=int, default=8)
    p.add_argument("--t0", type=float, default=1e-3)
    p.add_argument("--temp-schedule", default="cosine",
                   choices=["exp", "linear", "cosine", "log", "cauchy"])
    p.add_argument("--sigma-schedule", default="cosine", choices=["cosine", "linear", "exp"])
    p.add_argument("--mutpb", type=float, default=0.05)
    p.add_argument(
        "--proposal-mode", default="batched", choices=["batched", "sequential"],
        help="batched: one score of all tries per iteration; sequential: the "
        "reference's chaining, one batch-1 score per try",
    )
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
    p.add_argument("--cull-eps", type=float, default=None,
                   help="fast tier: the splat-contribution cull eps (default 2e-3)")
    p.add_argument("--metric", default="mse", choices=["mse", "ssim", "mix"])
    p.add_argument("--ssim-weight", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--no-video", action="store_true", help="write no frames and no animation")
    p.add_argument("--video-len", type=int, default=10, help="animation length, seconds")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save output_dir/sa_ckpt.npz every N iterations (0 = off)")
    p.add_argument("--resume", default="", help="continue from this checkpoint")
    p.add_argument(
        "--replicas", type=int, default=1,
        help=">1: parallel tempering, K chains on a geometric annealed ladder, "
        "proposals scored as one batch, neighbour swaps",
    )
    p.add_argument("--swap-every", type=int, default=10)
    p.add_argument("--t-hot", type=float, default=0.0, help="ladder top (default 100*t0)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Run SA (or PT); returns {"best_fit", "curves", "final" (the export render), "best"}."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from . import resolve_device
    from .config import GenomeConfig, MaskConfig, SAConfig
    from .models import sa
    from .ops import codec, mask as mask_mod, objective, render
    from .utils import io as io_mod

    dev = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    video_dir = os.path.join(args.output_dir, "video_frames_sa")
    save_video = not args.no_video
    target = io_mod.load_image(args.image)
    H_out, W_out = target.shape[0], target.shape[1]
    H, W = codec.choose_work_size(H_out, W_out, max_side=args.work_max_side)
    print(f"target {H_out}x{W_out} -> work {H}x{W} on {dev}")

    obj = objective.Objective(
        H=H, W=W, k_sigma=args.k_sigma, boost_only=args.boost_only, impl=args.impl,
        metric=args.metric, ssim_weight=args.ssim_weight, precision=args.precision,
        cull_eps=args.cull_eps,
    )
    sa_cfg = SAConfig(
        iterations=args.iterations, tries_per_iter=args.tries_per_iter, t0=args.t0,
        temp_schedule=args.temp_schedule, sigma_schedule=args.sigma_schedule,
        mutpb=args.mutpb, proposal_mode=args.proposal_mode,
    )
    gnm = GenomeConfig(n_splats=args.n_splats)
    mask_cfg = MaskConfig(strength=args.mask_strength, boost_only=args.boost_only)
    best, best_fit, curves = sa.simulated_annealing(
        target, H, W, obj=obj, sa=sa_cfg, gnm=gnm, mask_cfg=mask_cfg, seed=args.seed,
        log_every=args.log_every, save_video=save_video,
        frame_every=max(1, args.iterations // (args.fps * args.video_len)), video_dir=video_dir,
        loss_png_path=os.path.join(args.output_dir, "sa_loss.png"),
        loss_csv_path=os.path.join(args.output_dir, "sa_loss.csv"), loss_log_y=True,
        replicas=args.replicas, swap_every=args.swap_every, t_hot=args.t_hot,
        checkpoint_path=os.path.join(args.output_dir, "sa_ckpt.npz"),
        checkpoint_every=args.checkpoint_every, resume_from=args.resume, device=dev,
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
        print(f"SA Best {label} (exact rescore):", best_fit)
    else:
        print(f"SA Best {label}:", best_fit)
    if best_fit > 0 and args.metric == "mse":
        print(f"PSNR: {-10.0 * math.log10(best_fit):.2f} dB")

    # full-resolution export: rescale the genome, render once
    best_t = torch.as_tensor(best, device=dev)
    best_full = codec.scale_genome_pixels_anisotropic(best_t, sH=H_out / float(H), sW=W_out / float(W))
    g9 = codec.genome_to_renderer(best_full)
    final = render.render_splats(g9[None], H_out, W_out, k_sigma=args.k_sigma, impl=args.impl)[0]
    out_path = os.path.join(args.output_dir, "sa_splats.png")
    io_mod.save_image_u8(final, out_path)
    np.save(os.path.join(args.output_dir, "sa_best_genome.npy"), best)
    print(f"Saved full-resolution SA result as {out_path}")
    if save_video:
        anim = io_mod.assemble_apng(video_dir, "sa", os.path.join(args.output_dir, "sa_anim.apng"),
                                    fps=args.fps)
        if anim:
            print(f"Assembled animation: {anim}")
    return {"best_fit": best_fit, "curves": curves, "final": final, "best": best}


if __name__ == "__main__":
    main()
