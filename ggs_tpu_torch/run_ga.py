"""GA entry point of the port (runners/run_ga.py, for what the port supports).

Loads a target image, picks the working resolution, runs the GA on the
card, rescores the winner on the exact energy, and exports the
full-resolution render, the loss curves, the video frames and their
animation (`ga_anim.apng`; `--no-video` turns them off).

    python -m ggs_tpu_torch.run_ga --image synthetic --generations 5000

`--precision fast` scores with the fast tier (K4 table and eps-tight boxes,
corner-culled lists, the K3 exp2 walk) at `--cull-eps` (default 2e-3);
`--precision bf16` with the bf16 walk (K1-bf16); either way the winner is
rescored on the exact "highest" energy. `--metric ssim|mix` scores rendered
canvases with the SSIM energy (`--ssim-weight` for mix). `--memetic-every E`
gives the elites `--memetic-steps` Adam steps every E generations (the K7
kernel, over the eps-culled lists under "fast"; under "ssim" and "mix" K2'
and K6; refused under "bf16"). `--anneal-sigma0` runs scale-space
annealing, `--recycle-every/-k/-patience` the densify+prune recycle,
`--grow-stages`/`--grow-auto` error-guided growth over stages and
`--progressive` coarse-to-fine stages, each as runners/run_ga.py does.
`--islands I` runs the island model (demes of pop-size / I, `--migrate-k`
migrants around the ring every `--migrate-every` generations).
`--checkpoint-every K` saves `output_dir/ga_ckpt.npz` every K generations
and `--resume PATH` continues from such a file, bit for bit; with
`--profile-dir DIR` the first block after the start is traced with
torch.profiler into DIR. All three act on the last stage only, as in
runners/run_ga.py (a resumed staged run runs its earlier stages again).
`--pop-shards P --tile-shards T` evaluates over a (pop, tile) grid of P*T
processes launched by torchrun (one rank a process; parallel/mesh.py):

    torchrun --standalone --nproc-per-node 4 -m ggs_tpu_torch.run_ga \
        --pop-shards 2 --tile-shards 2

Every rank runs the GA on the whole population; each scores its pop
shard's candidates on its row slab of the canvas. Rank 0 alone prints and
writes the artifacts. Ranks that share one card talk over gloo, ranks with
a card each over NCCL. Without a process group, or with a world of another
size, the flags raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", default="imgs/reference.png",
                   help="image path, 'synthetic[:HxW]', a quality_target family "
                   "('gradient', 'portrait', 'texture', 'text', 'natural') or 'photo'")
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
    p.add_argument("--ssim-weight", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--no-video", action="store_true", help="write no frames and no animation")
    p.add_argument("--video-len", type=int, default=10, help="animation length, seconds")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--eval-chunk", type=int, default=0, help="0 = whole population at once")
    p.add_argument("--recycle-every", type=int, default=0,
                   help="every N generations, replace each candidate's k lowest-impact "
                   "splats with error-guided ones (fixed N)")
    p.add_argument("--recycle-k", type=int, default=0)
    p.add_argument("--recycle-patience", type=int, default=0,
                   help="also recycle whenever the best fitness stalls this many "
                   "generations (0 = periodic-only; composes with --recycle-every)")
    p.add_argument("--anneal-sigma0", type=float, default=0.0,
                   help="scale-space annealing: score sigma-blurred candidates against a "
                   "sigma-blurred target, sigma decaying from this value to 0 over the "
                   "first --anneal-frac of the budget (ops/anneal.py)")
    p.add_argument("--anneal-frac", type=float, default=0.6)
    p.add_argument(
        "--memetic-every", type=int, default=0,
        help="hybrid GA+Adam: every N generations give the elites --memetic-steps "
        "Adam steps through the differentiable renderer, each kept only when it "
        "improved on the GA's own energy (0 = off; exclusive with annealing)",
    )
    p.add_argument("--memetic-steps", type=int, default=5)
    p.add_argument("--memetic-lr", type=float, default=1e-2)
    p.add_argument("--grow-stages", type=int, default=1,
                   help=">1: error-guided growth, stage i fits n-splats/2^(S-1-i) splats, "
                   "then appends new splats at each candidate's highest-residual pixels")
    p.add_argument("--grow-auto", action="store_true",
                   help="stall-triggered growth: start at n-splats/8 and double whenever the "
                   "best stalls for --grow-patience generations")
    p.add_argument("--grow-patience", type=int, default=1500)
    p.add_argument("--fixed-mask", action="store_true",
                   help="with --progressive: one importance mask at the final resolution, "
                   "resized bilinearly for each stage")
    p.add_argument("--progressive", default="",
                   help="comma-separated work sides for coarse-to-fine stages, e.g. "
                   "'128,256,512' (overrides --work-max-side; --generations split equally)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save output_dir/ga_ckpt.npz every N generations (last stage; 0 = off)")
    p.add_argument("--resume", default="", help="continue the last stage from this checkpoint")
    p.add_argument("--islands", type=int, default=1,
                   help=">1: island-model GA (deme-local selection and elitism, ring "
                   "migration); pop-size must split into demes of an even size")
    p.add_argument("--migrate-every", type=int, default=0,
                   help="island migration cadence in generations (0 = never)")
    p.add_argument("--migrate-k", type=int, default=1,
                   help="migrants each island sends to the next")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the first block after the start here")
    p.add_argument("--pop-shards", type=int, default=1,
                   help="mesh pop axis: ranks that split the population (under torchrun)")
    p.add_argument("--tile-shards", type=int, default=1,
                   help="mesh tile axis: ranks that split the canvas rows (under torchrun)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Run the GA; returns {"best_fit", "curves", "final" (the export render),
    "best", "stages"}: "stages" holds each stage's n_splats, work size,
    generations run, best fitness and curves, the last stage's included."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.progressive and (args.grow_stages > 1 or args.grow_auto):
        parser.error("--progressive and --grow-stages/--grow-auto are mutually "
                     "exclusive; run progressive first, then a grow run "
                     "warm-started from its genome")
    if args.grow_auto and args.grow_stages > 1:
        parser.error("--grow-auto replaces --grow-stages' fixed schedule; "
                     "pass only one of them")

    from .parallel import mesh as mesh_mod

    # a process group made for these flags is destroyed when the run ends
    with mesh_mod.runner_mesh(args.pop_shards, args.tile_shards, args.device) as mesh:
        return _run(args, mesh)


def _run(args, mesh) -> dict:
    import numpy as np
    import torch

    from . import resolve_device
    from .config import GAConfig, GenomeConfig, MaskConfig
    from .models import ga, grow
    from .ops import codec, mask as mask_mod, objective, render
    from .utils import io as io_mod

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    main = mesh is None or mesh.is_main
    log = print if main else (lambda *a, **k: None)
    os.makedirs(args.output_dir, exist_ok=True)
    video_dir = os.path.join(args.output_dir, "video_frames")
    save_video = not args.no_video
    target = io_mod.load_image(args.image)
    H_out, W_out = target.shape[0], target.shape[1]
    H, W = codec.choose_work_size(H_out, W_out, max_side=args.work_max_side)
    log(f"target {H_out}x{W_out} -> work {H}x{W} on {dev}")

    obj = objective.Objective(
        H=H, W=W, k_sigma=args.k_sigma, boost_only=args.boost_only, impl=args.impl,
        chunk=args.eval_chunk or None, metric=args.metric, ssim_weight=args.ssim_weight,
        precision=args.precision, cull_eps=args.cull_eps,
    )
    ga_cfg = GAConfig(
        pop_size=args.pop_size, generations=args.generations, tour_k=args.tour_k,
        elite_k=args.elite_k, cxpb=args.cxpb, mutpb=args.mutpb, schedule=args.schedule,
    )
    mask_cfg = MaskConfig(strength=args.mask_strength, boost_only=args.boost_only)
    frame_every = max(1, args.generations // (args.fps * args.video_len))
    stages = []

    def run_stage(Hs, Ws, stage_cfg, init_pop, last, tag, n_splats=args.n_splats, patience=0,
                  weight_mask=None):
        out = ga.genetic_approx(
            target, Hs, Ws, obj=obj._replace(H=Hs, W=Ws), ga=stage_cfg,
            gnm=GenomeConfig(n_splats=n_splats), mask_cfg=mask_cfg, seed=args.seed,
            log_every=args.log_every, save_video=save_video and last, frame_every=frame_every,
            video_dir=video_dir, prefix="ga",
            loss_png_path=os.path.join(args.output_dir, f"ga_loss{tag}.png"),
            loss_csv_path=os.path.join(args.output_dir, f"ga_loss{tag}.csv"), device=dev,
            init_pop=init_pop, return_state=not last, recycle_every=args.recycle_every,
            recycle_k=args.recycle_k, recycle_patience=args.recycle_patience,
            stall_patience=patience, weight_mask=weight_mask,
            anneal_sigma0=args.anneal_sigma0 if last else 0.0, anneal_frac=args.anneal_frac,
            memetic_every=args.memetic_every, memetic_steps=args.memetic_steps,
            memetic_lr=args.memetic_lr,
            checkpoint_path=os.path.join(args.output_dir, "ga_ckpt.npz") if last else "",
            checkpoint_every=args.checkpoint_every if last else 0,
            resume_from=args.resume if last else "", n_islands=args.islands,
            migrate_every=args.migrate_every, migrate_k=args.migrate_k,
            profile_dir=args.profile_dir if last else "", mesh=mesh,
        )
        stages.append({"n_splats": n_splats, "work": (Hs, Ws),
                       "generations": len(out[2]["best"]) - 1, "best_fit": out[1],
                       "curves": out[2]})
        return out

    def work_target_and_mask():
        t_work = io_mod.ensure_hw(target, H, W, device=dev)
        return t_work, mask_mod.mask_from_config(t_work, H, W, mask_cfg)

    if args.progressive:
        # coarse-to-fine: the evolved population carries over through the
        # reference's anisotropic rescale into each finer stage
        sides = [int(s) for s in args.progressive.split(",") if s]
        gens_per = max(1, args.generations // len(sides))
        base_mask = None
        if args.fixed_mask:
            Hf, Wf = codec.choose_work_size(H_out, W_out, max_side=sides[-1])
            t_final = io_mod.ensure_hw(target, Hf, Wf, device=dev)
            base_mask = mask_mod.compute_importance_mask(
                t_final, Hf, Wf, smooth=mask_cfg.smooth, strength=mask_cfg.strength)
        pop0 = prev = None
        for i, side in enumerate(sides):
            Hs, Ws = codec.choose_work_size(H_out, W_out, max_side=side)
            if pop0 is not None and (Hs, Ws) != prev:
                pop0 = codec.scale_genome_pixels_anisotropic(
                    torch.as_tensor(pop0), sH=Hs / prev[0], sW=Ws / prev[1]).numpy()
            last = i == len(sides) - 1
            wm_s = None
            if base_mask is not None:
                wm_s = mask_mod.resize_bilinear(base_mask[None], Hs, Ws)[0]
            out = run_stage(Hs, Ws, dataclasses.replace(ga_cfg, generations=gens_per), pop0,
                            last, "" if last else f"_s{i}", weight_mask=wm_s)
            if last:
                best, best_fit, _ = out
            else:
                _, stage_fit, _, pop0 = out
                prev = (Hs, Ws)
                log(f"stage {i} ({Hs}x{Ws}): best MSE {stage_fit:.6f}")
        H, W = Hs, Ws
    elif args.grow_auto:
        # stall-triggered growth: each stage runs until the best has stalled
        # for --grow-patience generations or has used half of what is left,
        # then the budget doubles by error-guided growth up to --n-splats; the
        # remaining generations fund the full-size final stage
        t_work, wm = work_target_and_mask()
        grow_rng = torch.Generator(device=dev).manual_seed(args.seed + 101)
        n_i = max(8, args.n_splats // 8)
        gens_left = args.generations
        pop0 = None
        stage = 0
        while True:
            last = n_i >= args.n_splats
            stage_gens = max(1, gens_left if last else gens_left // 2)
            out = run_stage(H, W, dataclasses.replace(ga_cfg, generations=stage_gens), pop0,
                            last, "" if last else f"_a{stage}", n_splats=n_i,
                            patience=0 if last else args.grow_patience)
            if last:
                best, best_fit, _ = out
                break
            _, stage_fit, curves_s, pop0 = out
            used = max(1, len(curves_s["best"]) - 1)  # the curve's gen-0 entry is no run
            gens_left = max(1, gens_left - used)
            n_next = min(2 * n_i, args.n_splats)
            log(f"grow-auto stage {stage} (N={n_i}): best {stage_fit:.6f} "
                f"after {used} gens -> growing to {n_next}")
            pop0 = grow.grow_population(torch.as_tensor(pop0, device=dev), n_next - n_i, t_work,
                                        obj, weight_mask=wm, rng=grow_rng).cpu().numpy()
            n_i = n_next
            stage += 1
    elif args.grow_stages > 1:
        # fixed growth stages: budgets in proportion to each stage's splats
        S = args.grow_stages
        sizes = [max(8, args.n_splats // (2 ** (S - 1 - i))) for i in range(S)]
        sizes[-1] = args.n_splats
        total_n = sum(sizes)
        gens_stage = [max(1, args.generations * n // total_n) for n in sizes]
        t_work, wm = work_target_and_mask()
        grow_rng = torch.Generator(device=dev).manual_seed(args.seed + 101)
        pop0 = None
        for i, n_i in enumerate(sizes):
            last = i == S - 1
            out = run_stage(H, W, dataclasses.replace(ga_cfg, generations=gens_stage[i]), pop0,
                            last, "" if last else f"_g{i}", n_splats=n_i)
            if last:
                best, best_fit, _ = out
            else:
                _, stage_fit, _, pop0 = out
                log(f"grow stage {i} (N={n_i}): best MSE {stage_fit:.6f}")
                pop0 = grow.grow_population(torch.as_tensor(pop0, device=dev),
                                            sizes[i + 1] - n_i, t_work, obj, weight_mask=wm,
                                            rng=grow_rng).cpu().numpy()
    else:
        best, best_fit, _ = run_stage(H, W, ga_cfg, None, True, "")

    label = "MSE" if args.metric == "mse" else f"energy ({args.metric})"
    if args.precision != "highest":
        # rescore the winner on the exact energy so the number reported is
        # independent of the evaluation tier (at the last stage's size)
        t_work = io_mod.ensure_hw(target, H, W, device=dev)
        wm = mask_mod.mask_from_config(t_work, H, W, mask_cfg)
        best_fit = float(
            objective.evaluate(
                obj._replace(H=H, W=W, precision="highest", cull_eps=None), best[None], t_work,
                wm, device=dev,
            )[0]
        )
        log(f"Best {label} (exact rescore):", best_fit)
    else:
        log(f"Best {label}:", best_fit)
    if best_fit > 0 and args.metric == "mse":
        log(f"PSNR: {-10.0 * math.log10(best_fit):.2f} dB")

    # full-resolution export (run_ggs.py:64-77): rescale the genome, render once
    best_t = torch.as_tensor(best, device=dev)
    best_full = codec.scale_genome_pixels_anisotropic(best_t, sH=H_out / float(H), sW=W_out / float(W))
    g9 = codec.genome_to_renderer(best_full)
    final = render.render_splats(g9[None], H_out, W_out, k_sigma=args.k_sigma, impl=args.impl)[0]
    out_path = os.path.join(args.output_dir, "ga_splats.png")
    if main:
        io_mod.save_image_u8(final, out_path)
        np.save(os.path.join(args.output_dir, "ga_best_genome.npy"), best)
        print(f"Saved full resolution result as {out_path}")
    if save_video and main:
        anim = io_mod.assemble_apng(video_dir, "ga", os.path.join(args.output_dir, "ga_anim.apng"),
                                    fps=args.fps)
        if anim:
            print(f"Assembled animation: {anim}")
    return {"best_fit": best_fit, "curves": stages[-1]["curves"], "final": final, "best": best,
            "stages": stages}


if __name__ == "__main__":
    main()
