"""The port's sharding (ggs_tpu_torch/parallel/, the sharded paths of
ops/objective.py and models/gradient.py) in real gloo worlds of 2 and 4
processes on the CPU, against the JAX package's sharded functions on a 2x2
mesh of the virtual CPU devices (Pallas in interpret mode) and against the
port's own unsharded functions, on the same seeded inputs.

Each world runs once for the module (tests/torch_dist_worker.py, one
process a rank, a FileStore under the test's tmp dir) with its own
communicate(timeout=...), which kills its ranks on a timeout, so a hang
fails a test instead of eating the suite's time limit.

Tolerances, those of the JAX package's sharding tests
(tests/test_sharding.py): fits rtol 2e-5, atol 1e-6 (:48, :115, :289); the
fast tier with the corner cull against the unsharded fitness atol 2e-3
(:339: the slab's tile rects move the corner cull); the tile-sharded loss
rtol 2e-5 and its gradients rtol 2e-4 with atol 1e-6 (mse) or 2e-6 (mix)
(:175-177, :229-234). The ranks' states are compared by hash (equal bits),
pop-only sharding against the single-process run in bits, the migration
ring and the distributed checkpoint's resume in bits.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices
from ggs_tpu.models import gradient as jgradient
from ggs_tpu.ops import objective as jobjective
from ggs_tpu.parallel import mesh as jmesh, shard as jshard
from ggs_tpu_torch.config import GenomeConfig
from ggs_tpu_torch.models import gradient
from ggs_tpu_torch.ops import objective
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

import torch_dist_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
H, W, B, N = 32, 64, 4, 12  # evaluate: 16-row slabs at tile 2 (> the SSIM halo)
HG, WG = 32, 48  # the tile-sharded loss
WORLD_TIMEOUT = 150  # seconds a world may take before its ranks are killed


def _inputs():
    return {
        "H": np.int64(H), "W": np.int64(W),
        "pop": axes_genomes(300, B, N, H, W), "target": image(301, H, W),
        "mask": weights(302, H, W),
        "Hg": np.int64(HG), "Wg": np.int64(WG),
        "gpop": axes_genomes(303, 2, 8, HG, WG), "gtarget": image(304, HG, WG),
        "gmask": weights(305, HG, WG),
        "mig_pop": axes_genomes(306, 8, 4, H, W),
        "mig_fits": np.random.default_rng(307).permutation(8).astype(np.float32) / 8.0,
    }


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _run_world(n: int, d) -> list:
    """One world of n ranks on the inputs -> each rank's outputs."""
    inputs = os.path.join(d, "inputs.npz")
    np.savez(inputs, **_inputs())
    store = os.path.join(d, "store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), store, str(n), str(r),
         inputs, str(d)], env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the {n}-rank world did not finish in {WORLD_TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {n} exited {p.returncode}:\n{log[-4000:]}"
    return [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(n)]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _run_world(4, tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _run_world(2, tmp_path_factory.mktemp("world2"))


def _jmesh():
    return jmesh.make_mesh(2, 2, cpu_devices(4))


def _same_on_every_rank(outs, key):
    for r, o in enumerate(outs[1:], 1):
        a, b = np.asarray(outs[0][key]), np.asarray(o[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), f"{key}: rank {r} differs"


@pytest.mark.parametrize("case", worker.EVAL_CASES, ids=[c[0] for c in worker.EVAL_CASES])
def test_sharded_evaluate_matches_jax(world4, case):
    """2x2 sharded evaluate on every rank (the same bits) against JAX's
    _evaluate_fused_sharded / _evaluate_metric_sharded on a 2x2 mesh, and
    against the port's unsharded evaluate."""
    name, metric, precision, mask, boost = case
    key = f"eval_{name}"
    _same_on_every_rank(world4, key)
    got = world4[0][key]
    inp = _inputs()
    wm = inp["mask"] if mask else None
    jobj = jshard.sharded_objective(jobjective.Objective(
        H=H, W=W, impl="pallas", interpret=True, metric=metric, precision=precision,
        boost_only=boost), _jmesh())
    fn = jobjective._evaluate_fused_sharded if metric == "mse" else \
        jobjective._evaluate_metric_sharded
    want = jax.jit(lambda p, t, w: fn(jobj, p, t, w))(
        jnp.asarray(inp["pop"]), jnp.asarray(inp["target"]),
        None if wm is None else jnp.asarray(wm))
    assert want is not None
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=1e-6)
    tobj = objective.Objective(H=H, W=W, metric=metric, precision=precision, boost_only=boost)
    unsharded = objective.evaluate(tobj, inp["pop"], inp["target"], wm, device="cpu").numpy()
    atol = 2e-3 if precision == "fast" else 1e-6
    np.testing.assert_allclose(got, unsharded, rtol=2e-5, atol=atol)


@pytest.mark.parametrize("case", worker.GRAD_CASES, ids=[c[0] for c in worker.GRAD_CASES])
def test_tile_sharded_loss_matches_jax(world4, case):
    """The 2x2 tile-sharded loss and its genome gradients (K2'/K6 on slabs,
    psum, the SSIM halo, the gradient all-reduce) against JAX's
    _make_sharded_loss_fn under jax.value_and_grad (a batch that splits over
    pop), and the port's unsharded value_and_grad; a single genome runs
    replicated over pop."""
    name, metric, mask, batch = case
    for suffix in ("loss", "fits", "grads"):
        _same_on_every_rank(world4, f"{name}_{suffix}")
    inp = _inputs()
    g = inp["gpop"][:batch]
    wm = inp["gmask"] if mask else None
    gtol = 1e-6 if metric == "mse" else 2e-6
    out = world4[0]
    if batch % 2 == 0:  # (JAX's replicated single genome costs another compile)
        jobj = jshard.sharded_objective(jobjective.Objective(
            H=HG, W=WG, impl="pallas", interpret=True, metric=metric), _jmesh())
        loss_fn = jgradient._make_sharded_loss_fn(jobj)
        (l0, f0), g0 = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jnp.asarray(g), jnp.asarray(inp["gtarget"]), None if wm is None else jnp.asarray(wm))
        np.testing.assert_allclose(out[f"{name}_loss"], float(l0), rtol=2e-5)
        np.testing.assert_allclose(out[f"{name}_fits"], np.asarray(f0), rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(out[f"{name}_grads"], np.asarray(g0), rtol=2e-4, atol=gtol)
    vg = gradient.make_value_and_grad(objective.Objective(H=HG, W=WG, metric=metric),
                                      GenomeConfig(n_splats=8))
    (l1, _), g1 = vg(torch.from_numpy(g), torch.from_numpy(inp["gtarget"]),
                     None if wm is None else torch.from_numpy(wm))
    np.testing.assert_allclose(out[f"{name}_loss"], float(l1), rtol=2e-5)
    np.testing.assert_allclose(out[f"{name}_grads"], g1.numpy(), rtol=2e-4, atol=gtol)


def test_migrate_ring_matches_jax(world4):
    """migrate_ring over the 2 pop shards, equal to JAX's shard.migrate_ring."""
    _same_on_every_rank(world4, "mig_pop")
    inp = _inputs()
    jp, jf = jshard.migrate_ring(jnp.asarray(inp["mig_pop"]), jnp.asarray(inp["mig_fits"]), 2,
                                 _jmesh())
    np.testing.assert_array_equal(world4[0]["mig_pop"], np.asarray(jp))
    np.testing.assert_array_equal(world4[0]["mig_fits"], np.asarray(jf))


def test_sharded_ga_block_identical_on_every_rank(world4):
    """The 2x2 GA's state after every block hashes the same on every rank,
    and its best falls."""
    _same_on_every_rank(world4, "ga_hashes")
    _same_on_every_rank(world4, "ga_metrics")
    best = world4[0]["ga_metrics"][:, 0]
    assert best[-1] <= best[0] and len(set(world4[0]["ga_hashes"])) == worker.GA_BLOCKS + 1


def test_distributed_checkpoint_resumes_in_bits(world4):
    """run(4) == run(2) -> save_checkpoint_distributed -> load -> run(2)."""
    assert all(bool(o["ckpt_same"]) for o in world4)


def test_wrong_world_size_raises(world4):
    for o in world4:
        assert "needs 3 ranks, the world has 4" in str(o["wrong_world"])


def test_mesh_layout(world4):
    """auto_mesh splits 4 ranks 2x2; rank r sits at (r // 2, r % 2), the
    layout of np.arange(n).reshape(pop, tile) (mesh.py:44)."""
    for r, o in enumerate(world4):
        assert list(o["auto_mesh"]) == [2, 2, r // 2, r % 2]


def test_pop_only_sharding_equals_single_process(world2):
    """Pop-only sharding (2x1) gives the single-process trajectory in bits;
    tile-only (1x2) the same fits within rtol 2e-5."""
    for key in ("pop_hashes", "tile_hashes", "single_hashes"):
        _same_on_every_rank(world2, key)
    o = world2[0]
    assert list(o["pop_hashes"]) == list(o["single_hashes"])
    np.testing.assert_allclose(o["tile_metrics"], o["single_metrics"], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("tag", ["pop", "tile"])
def test_mix_gradient_2_ranks(world2, tag):
    """The mix loss's gradient on a 2x1 and a 1x2 mesh against the port's
    unsharded value_and_grad."""
    inp = _inputs()
    vg = gradient.make_value_and_grad(objective.Objective(H=HG, W=WG, metric="mix"),
                                      GenomeConfig(n_splats=8))
    (l1, _), g1 = vg(torch.from_numpy(inp["gpop"]), torch.from_numpy(inp["gtarget"]), None)
    o = world2[0]
    np.testing.assert_allclose(o[f"{tag}_mix_loss"], float(l1), rtol=2e-5)
    np.testing.assert_allclose(o[f"{tag}_mix_grads"], g1.numpy(), rtol=2e-4, atol=2e-6)


TOY = ["--image", "synthetic:48x128", "--work-max-side", "128", "--n-splats", "16",
       "--pop-size", "8", "--elite-k", "2", "--generations", "6", "--log-every", "3",
       "--no-video", "--device", "cpu"]


def test_torchrun_run_ga_matches_single_process(tmp_path):
    """`torchrun --nproc-per-node 2 -m ggs_tpu_torch.run_ga --pop-shards 2`
    at a toy size: the best genome equals the single-process run's in bits,
    and the artifacts are written once (by rank 0)."""
    from ggs_tpu_torch import run_ga

    out2 = tmp_path / "two"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "ggs_tpu_torch.run_ga", *TOY, "--pop-shards", "2", "--output-dir",
           str(out2)]
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=WORLD_TIMEOUT, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("Saved full resolution result") == 1
    assert proc.stdout.count("mesh: pop=2 x tile=1 over 2 ranks, backend gloo") == 1
    res = run_ga.main([*TOY, "--output-dir", str(tmp_path / "one")])
    two = np.load(out2 / "ga_best_genome.npy")
    assert two.tobytes() == res["best"].tobytes()


def test_flags_without_process_group_raise(monkeypatch, tmp_path):
    """--pop-shards / --tile-shards with no process group raise and name the
    torchrun command: a sharded run never quietly runs one process."""
    from ggs_tpu_torch import run_ga, run_grad

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        run_ga.main([*TOY, "--pop-shards", "2", "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="torchrun"):
        run_grad.main(["--image", "synthetic:48x160", "--tile-shards", "2", "--device", "cpu",
                       "--output-dir", str(tmp_path)])
