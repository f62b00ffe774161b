"""Gradient-fitting entry point of the port (runners/run_grad.py, for what
the port supports): projected Adam on one splat set through the exact
differentiable renderer, on the card.

    python -m ggs_tpu_torch.run_grad --image synthetic --steps 2000

Each Adam step is one fused K7 launch (forward walk, loss head, backward
walk); under `--precision fast` it walks the eps-culled lists (`--cull-eps`,
default 2e-3, and the corner cull), giving the exact gradients of that
culled render. `--metric ssim|mix` (`--ssim-weight` for mix) differentiates
the SSIM energy of the rendered canvas: K2' forward and K6 backward each
step, no K7. `--anneal-sigma0` runs the scale-space homotopy: each step
scores the sigma-blurred genome against the sigma-blurred target on the
same path and chains the gradient back through the blur, sigma decaying to
0 over the first `--anneal-frac` of the steps. The final loss is rescored
on the "highest" energy. `--pop-shards P --tile-shards T` runs the
tile-sharded loss over P*T processes launched by torchrun:

    torchrun --standalone --nproc-per-node 2 -m ggs_tpu_torch.run_grad --tile-shards 2

Each rank renders its row slab (K2' forward, K6 backward, no K7) and the
genome gradient is summed over the tile group; the single genome runs
replicated over the pop axis. Rank 0 alone prints and writes the
artifacts. Without a process group, or with a world of another size, the
flags raise.
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
    p.add_argument("--n-splats", type=int, default=2000)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--k-sigma", type=float, default=3.0)
    p.add_argument("--mask-strength", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--init-from", default="", help=".npy genome [N, 9] to warm-start from")
    p.add_argument("--impl", default="cuda", choices=["cuda", "oracle"])
    p.add_argument("--metric", default="mse", choices=["mse", "ssim", "mix"])
    p.add_argument("--ssim-weight", type=float, default=0.5)
    p.add_argument("--anneal-sigma0", type=float, default=0.0,
                   help="scale-space homotopy: optimize the sigma-smoothed landscape first, "
                   "sigma decaying to 0 over the first --anneal-frac of the steps")
    p.add_argument("--anneal-frac", type=float, default=0.6)
    p.add_argument(
        "--precision", default="exact-tight", choices=["highest", "exact-tight", "fast"],
        help="exact-tight (default): exact gradients of the tight k-sigma box "
        "render; highest: the reference's conservative box; fast: exact "
        "gradients of the eps-culled render (sub-eps splats get zero gradient). "
        "The final loss is always rescored on the highest energy.",
    )
    p.add_argument("--cull-eps", type=float, default=None,
                   help="fast tier: the cull eps (default 2e-3)")
    p.add_argument("--pop-shards", type=int, default=1,
                   help="mesh pop axis: genome-batch shards (under torchrun)")
    p.add_argument("--tile-shards", type=int, default=1,
                   help="mesh tile axis: canvas-row shards, gradients summed over them")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Run the fit; returns {"best_loss", "curve", "best", "final" (the export render)}."""
    args = build_parser().parse_args(argv)

    from .parallel import mesh as mesh_mod

    # a process group made for these flags is destroyed when the run ends
    with mesh_mod.runner_mesh(args.pop_shards, args.tile_shards, args.device) as mesh:
        return _run(args, mesh)


def _run(args, mesh) -> dict:
    import numpy as np
    import torch

    from . import resolve_device
    from .config import GenomeConfig, GradConfig, MaskConfig
    from .models import gradient
    from .ops import codec, mask as mask_mod, objective, render
    from .utils import curves as curves_mod
    from .utils import io as io_mod

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    main = mesh is None or mesh.is_main
    log = print if main else (lambda *a, **k: None)
    os.makedirs(args.output_dir, exist_ok=True)
    target = io_mod.load_image(args.image)
    H_out, W_out = target.shape[0], target.shape[1]
    H, W = codec.choose_work_size(H_out, W_out, max_side=args.work_max_side)
    log(f"target {H_out}x{W_out} -> work {H}x{W} on {dev}")

    obj = objective.Objective(
        H=H, W=W, k_sigma=args.k_sigma, impl=args.impl, metric=args.metric,
        ssim_weight=args.ssim_weight, precision=args.precision, cull_eps=args.cull_eps,
        mesh=mesh,
    )
    gnm = GenomeConfig(n_splats=args.n_splats)
    cfg = GradConfig(steps=args.steps, lr=args.lr)
    t = io_mod.ensure_hw(target, H, W, device=dev)
    wm = mask_mod.mask_from_config(t, H, W, MaskConfig(strength=args.mask_strength))

    init = np.load(args.init_from) if args.init_from else None
    best, best_loss, curve = gradient.fit_adam(
        t, H, W, obj=obj, gnm=gnm, cfg=cfg, init_genomes=init, weight_mask=wm,
        seed=args.seed, log_every=args.log_every, anneal_sigma0=args.anneal_sigma0,
        anneal_frac=args.anneal_frac, device=dev, progress=main,
    )
    log("Final loss:", best_loss)
    if best_loss > 0 and args.metric == "mse":
        log(f"PSNR: {-10.0 * math.log10(best_loss):.2f} dB")
    best_t = torch.as_tensor(best, device=dev)
    best_full = codec.scale_genome_pixels_anisotropic(best_t, sH=H_out / float(H), sW=W_out / float(W))
    g9 = codec.genome_to_renderer(best_full)
    final = render.render_splats(g9[None], H_out, W_out, k_sigma=args.k_sigma, impl=args.impl)[0]
    if not main:
        return {"best_loss": best_loss, "curve": curve, "best": best, "final": final}

    curves_mod.save_loss_curve_png(
        {"loss": curve}, os.path.join(args.output_dir, "grad_loss.png"),
        title="Adam fitting", xlabel="Step",
        ylabel="MSE" if args.metric == "mse" else f"energy ({args.metric})", log_y=True,
    )
    curves_mod.save_curves_csv({"loss": curve}, os.path.join(args.output_dir, "grad_loss.csv"))
    np.save(os.path.join(args.output_dir, "grad_genome.npy"), best)
    out_path = os.path.join(args.output_dir, "grad_splats.png")
    io_mod.save_image_u8(final, out_path)
    print(f"Saved full-resolution gradient-fit result as {out_path}")
    return {"best_loss": best_loss, "curve": curve, "best": best, "final": final}


if __name__ == "__main__":
    main()
