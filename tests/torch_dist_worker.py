"""One rank of a gloo world for tests/test_torch_sharding.py (imports no JAX).

    python tests/torch_dist_worker.py STORE WORLD RANK INPUTS.npz OUT_DIR

Joins the world through a FileStore at STORE, builds the port's meshes over
it on the CPU, runs the sharded paths on the inputs the test wrote and
saves what it got to OUT_DIR/rank<RANK>.npz; the test compares them with
the JAX package's sharded functions and with the port's unsharded ones.
A world of 4 runs the 2x2 mesh (evaluate, the tile-sharded loss, the
migration ring, a GA block, the distributed checkpoint) and the refusals of
another world size; a world of 2 runs pop-only and tile-only GA blocks
beside the single-process port on the same seed.
"""
from __future__ import annotations

import hashlib
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ggs_tpu_torch.config import GAConfig, GenomeConfig  # noqa: E402
from ggs_tpu_torch.models import ga, gradient  # noqa: E402
from ggs_tpu_torch.ops import objective  # noqa: E402
from ggs_tpu_torch.parallel import mesh as mesh_mod, shard  # noqa: E402
from ggs_tpu_torch.utils import checkpoint  # noqa: E402

# the evaluate cases: (name, metric, precision, mask, boost_only)
EVAL_CASES = (
    ("mse_highest_nomask", "mse", "highest", False, False),
    ("mse_highest_mask", "mse", "highest", True, False),
    ("mse_highest_boost", "mse", "highest", True, True),
    ("mse_tight_mask", "mse", "exact-tight", True, False),
    ("mse_fast_mask", "mse", "fast", True, False),
    ("mse_bf16_mask", "mse", "bf16", True, False),
    ("ssim_highest_nomask", "ssim", "highest", False, False),
    ("mix_highest_mask", "mix", "highest", True, False),
    ("mix_fast_mask", "mix", "fast", True, False),
)
# the tile-sharded loss cases: (name, metric, mask, batch)
GRAD_CASES = (
    ("grad_mse_mask", "mse", True, 2),
    ("grad_mix_nomask", "mix", False, 2),
    ("grad_mse_single", "mse", False, 1),
)
GA_CFG = GAConfig(pop_size=8, generations=40, elite_k=2)
GA_GNM = GenomeConfig(n_splats=8)
GA_BLOCKS, GA_GENS = 3, 4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def state_hash(st) -> str:
    h = hashlib.sha256()
    for x in (st.pop, st.fits, st.best, st.best_fit, st.no_improve, st.rng.get_state()):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    h.update(str(st.gen).encode())
    return h.hexdigest()


def ga_blocks(obj, tgt, wm, seed=5):
    """GA_BLOCKS blocks of GA_GENS generations -> (state hashes, metrics)."""
    rng = torch.Generator().manual_seed(seed)
    st = ga.init(rng, obj, tgt, wm, GA_CFG, GA_GNM)
    hashes, rows = [state_hash(st)], []
    for _ in range(GA_BLOCKS):
        st, m = ga.run_block(st, obj, tgt, wm, GA_CFG, GA_GNM, GA_GENS)
        hashes.append(state_hash(st))
        rows.append(m.numpy())
    return hashes, np.concatenate(rows)


def world4(inp, out, store, world, rank, out_dir):
    m = mesh_mod.make_mesh(2, 2, device="cpu", init_method=store, world_size=world, rank=rank)
    H, W = int(inp["H"]), int(inp["W"])
    pop, tgt, wm = _t(inp["pop"]), _t(inp["target"]), _t(inp["mask"])
    for name, metric, precision, mask, boost in EVAL_CASES:
        obj = objective.Objective(H=H, W=W, metric=metric, precision=precision,
                                  boost_only=boost, mesh=m)
        out[f"eval_{name}"] = objective.evaluate(obj, pop, tgt, wm if mask else None,
                                                 device="cpu").numpy()
    Hg, Wg = int(inp["Hg"]), int(inp["Wg"])
    gpop, gtgt, gwm = _t(inp["gpop"]), _t(inp["gtarget"]), _t(inp["gmask"])
    for name, metric, mask, batch in GRAD_CASES:
        obj = objective.Objective(H=Hg, W=Wg, metric=metric, mesh=m)
        vg = gradient.make_value_and_grad(obj, GenomeConfig(n_splats=gpop.shape[1]))
        (loss, fits), grads = vg(gpop[:batch], gtgt, gwm if mask else None)
        out[f"{name}_loss"] = loss.numpy()
        out[f"{name}_fits"] = fits.numpy()
        out[f"{name}_grads"] = grads.numpy()
    mp, mf = shard.migrate_ring(_t(inp["mig_pop"]), _t(inp["mig_fits"]), 2, m)
    out["mig_pop"], out["mig_fits"] = mp.numpy(), mf.numpy()

    obj = objective.Objective(H=H, W=W, precision="exact-tight", mesh=m)
    out["ga_hashes"], out["ga_metrics"] = ga_blocks(obj, tgt, wm)

    # the distributed checkpoint: run(4) == run(2) -> save -> load -> run(2)
    path = os.path.join(out_dir, "ga_ckpt.npz")
    st0 = ga.init(torch.Generator().manual_seed(9), obj, tgt, wm, GA_CFG, GA_GNM)
    full, _ = ga.run_block(st0, obj, tgt, wm, GA_CFG, GA_GNM, 4)
    st0 = ga.init(torch.Generator().manual_seed(9), obj, tgt, wm, GA_CFG, GA_GNM)
    half, _ = ga.run_block(st0, obj, tgt, wm, GA_CFG, GA_GNM, 2)
    checkpoint.save_checkpoint_distributed(path, half, {"gen": 2}, mesh=m)
    tmpl = ga.init(torch.Generator().manual_seed(9), obj, tgt, wm, GA_CFG, GA_GNM)
    loaded, meta = checkpoint.load_checkpoint(path, tmpl)
    resumed, _ = ga.run_block(loaded, obj, tgt, wm, GA_CFG, GA_GNM, 2)
    out["ckpt_same"] = np.array(state_hash(resumed) == state_hash(full) and meta["gen"] == 2)

    auto = mesh_mod.auto_mesh(device="cpu")
    out["auto_mesh"] = np.array([auto.pop_shards, auto.tile_shards, auto.pop_index,
                                 auto.tile_index])
    try:
        mesh_mod.make_mesh(3, 1, device="cpu")
        out["wrong_world"] = np.array("no error")
    except ValueError as e:
        out["wrong_world"] = np.array(str(e))


def world2(inp, out, store, world, rank, out_dir):
    H, W = int(inp["H"]), int(inp["W"])
    tgt, wm = _t(inp["target"]), _t(inp["mask"])
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    single = ga_blocks(obj, tgt, wm)
    out["single_hashes"], out["single_metrics"] = single
    for tag, (p, t) in (("pop", (2, 1)), ("tile", (1, 2))):
        m = mesh_mod.make_mesh(p, t, device="cpu", init_method=store, world_size=world,
                               rank=rank)
        out[f"{tag}_hashes"], out[f"{tag}_metrics"] = ga_blocks(obj._replace(mesh=m), tgt, wm)
        gobj = objective.Objective(H=int(inp["Hg"]), W=int(inp["Wg"]), metric="mix", mesh=m)
        vg = gradient.make_value_and_grad(gobj, GenomeConfig(n_splats=8))
        (loss, _), grads = vg(_t(inp["gpop"]), _t(inp["gtarget"]), None)
        out[f"{tag}_mix_loss"], out[f"{tag}_mix_grads"] = loss.numpy(), grads.numpy()


def main(argv):
    store, world, rank, inputs, out_dir = argv
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    inp = dict(np.load(inputs))
    out = {}
    (world4 if world == 4 else world2)(inp, out, "file://" + store, world, rank, out_dir)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()  # gloo's threads torn down before the interpreter exits


if __name__ == "__main__":
    main(sys.argv[1:])
