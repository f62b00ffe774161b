"""Port gradient fitting (ggs_tpu_torch/models/gradient.py, the memetic block
of models/ga.py, run_grad) against ggs_tpu/models/gradient.py, and the
invariants tests/test_gradient.py pins, on the CPU (the K7 wrapper takes its
plain version there).

Adam across packages: a JAX state after two steps is carried across with
convert.grad_state_from_jax, then both packages take five steps. Measured
gap on these inputs (both impls of the port): genomes within 7e-7 in the
first five columns and 1.9e-6 in the 0-255 color/alpha columns, fits within
1.2e-6 relative. Held to about 10x that: atol 1e-5 and 2e-5, rtol 1e-5.
The remaining gap is rounding: the codec's exp/cos/sin are 1-2 ulp apart
in XLA and PyTorch, and optax and torch.optim order Adam's bias correction
differently."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.config import GenomeConfig as JGenomeConfig
from ggs_tpu.config import GradConfig as JGradConfig
from ggs_tpu.models import gradient as jgradient
from ggs_tpu.ops import objective as jobjective
from ggs_tpu_torch import convert, run_grad
from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig
from ggs_tpu_torch.models import ga as tga
from ggs_tpu_torch.models import genome as tgenome
from ggs_tpu_torch.models import gradient as tgradient
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import objective as tobjective
from ggs_tpu_torch.ops import oracle as toracle
from ggs_tpu_torch.ops import render_grad as trg
from ggs_tpu_torch.parallel import mesh as tmesh
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H = W = 24
GNM = GenomeConfig(n_splats=8, min_scale=1.0, max_scale=0.3)
OBJ = tobjective.Objective(H=H, W=W, precision="exact-tight")  # impl "cuda": K7's plain version


def _target(seed):
    """An in-model target: the oracle's render of another random genome."""
    g = tgenome.new_population(torch.Generator().manual_seed(seed), 1, 8, H, W, 1.0, 0.3, "cpu")
    return toracle.render_dense(tcodec.genome_to_renderer(g), H, W)[0]


def _pop(seed, B):
    return tgenome.new_population(torch.Generator().manual_seed(seed), B, 8, H, W, 1.0, 0.3, "cpu")


@pytest.mark.parametrize("impl", ["cuda", "oracle"])
def test_adam_steps_match_jax_from_carried_state(impl):
    Hc, Wc, N, B = 32, 48, 8, 2
    g0 = axes_genomes(11, B, N, Hc, Wc, 0.3)
    tgt, wm = image(12, Hc, Wc), weights(13, Hc, Wc)
    jobj = jobjective.Objective(H=Hc, W=Wc, impl="xla", precision="exact-tight")
    opt, jstep = jgradient.make_fit_step(
        jobj, JGenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3), JGradConfig(lr=1e-2)
    )
    jstep = jax.jit(jstep)
    js = jgradient.init_state(opt, jnp.asarray(g0))
    for _ in range(2):
        js, _ = jstep(js, jnp.asarray(tgt), jnp.asarray(wm))
    adam = js.opt_state[0]
    ts = convert.grad_state_from_jax(
        np.asarray(js.g), np.asarray(adam.mu), np.asarray(adam.nu), np.asarray(adam.count),
        GradConfig(lr=1e-2), device="cpu",
    )
    assert ts.step == 2 and float(ts.opt.state[ts.g]["step"]) == 2.0
    tobj = tobjective.Objective(H=Hc, W=Wc, impl=impl, precision="exact-tight")
    _, tstep = tgradient.make_fit_step(
        tobj, GenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3), GradConfig(lr=1e-2)
    )
    for _ in range(5):
        js, fj = jstep(js, jnp.asarray(tgt), jnp.asarray(wm))
        ts, ft = tstep(ts, torch.from_numpy(tgt), torch.from_numpy(wm))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)
    gj = np.asarray(js.g)
    np.testing.assert_allclose(ts.g[..., :5].numpy(), gj[..., :5], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.g[..., 5:].numpy(), gj[..., 5:], atol=2e-5, rtol=0)
    assert ts.step == 7


def test_adam_reduces_loss():
    target = _target(3001)
    cfg = GradConfig(steps=60, lr=2e-2)
    make_opt, step = tgradient.make_fit_step(OBJ, GNM, cfg)
    g0 = _pop(1, 2)
    loss_fn = tgradient.make_loss_fn(OBJ, GNM)
    l0, _ = loss_fn(g0, target, None)
    state, fits = tgradient.run_block(tgradient.init_state(make_opt, g0), step, target, None, 60)
    l1, _ = loss_fn(state.g, target, None)
    assert fits.shape == (60, 2)
    assert float(l1) < float(l0) * 0.7  # solid descent on an in-model target
    f = fits.mean(dim=1)
    assert float(f[-1]) < float(f[0])


def test_adam_respects_domain():
    target = _target(3002)
    cfg = GradConfig(steps=30, lr=5e-1)  # big steps to slam into the clamps
    make_opt, step = tgradient.make_fit_step(OBJ, GNM, cfg)
    state, _ = tgradient.run_block(tgradient.init_state(make_opt, _pop(2, 1)), step, target, None, 30)
    g = state.g.numpy()
    assert g[..., 0:2].min() >= 0.0 and g[..., 0:2].max() <= 1.0
    lo, hi = np.log(GNM.min_scale), np.log(GNM.max_scale * max(H, W))
    assert g[..., 2:4].min() >= lo - 1e-5 and g[..., 2:4].max() <= hi + 1e-5
    assert np.abs(g[..., 4]).max() <= np.pi + 1e-6
    assert g[..., 5:9].min() >= 0.0 and g[..., 5:9].max() <= 255.0


def test_fit_adam_driver():
    target = _target(3003)
    best, best_loss, curve = tgradient.fit_adam(
        target, H, W, obj=OBJ, gnm=GNM, cfg=GradConfig(steps=40, lr=2e-2),
        seed=0, log_every=20, progress=False, device="cpu",
    )
    assert best.shape == (8, 9)
    assert len(curve) == 40
    assert best_loss <= curve[0]
    # the reported loss is the "highest" energy of the returned genome
    want = tobjective.evaluate(OBJ._replace(precision="highest"), best[None], target, device="cpu")
    np.testing.assert_allclose(best_loss, float(want[0]), rtol=1e-5, atol=1e-7)


def test_refine_elites_never_worsens():
    target = _target(3004)
    elites = _pop(4, 3)
    fits = tobjective.evaluate(OBJ, elites, target, None, device="cpu")
    el2, f2 = tgradient.refine_elites(
        elites, fits, target, None, OBJ, GNM, GradConfig(lr=1e-2), steps=10
    )
    assert np.all(f2.numpy() <= fits.numpy() + 1e-7)
    # the fits reported are the GA evaluator's numbers for the returned genomes
    f_check = tobjective.evaluate(OBJ, el2, target, None, device="cpu")
    np.testing.assert_allclose(f2.numpy(), f_check.numpy(), rtol=1e-5, atol=1e-6)
    assert float(f2.min()) < float(fits.min())


def test_memetic_block_keeps_best_monotone():
    target = _target(3005)
    cfg = GAConfig(pop_size=8, generations=20, elite_k=2, cxpb=0.2, mutpb=0.2)
    st = tga.init(torch.Generator().manual_seed(5), OBJ, target, None, cfg, GNM)
    b0 = float(st.best_fit)
    before = trg.lossgrad_tiles.launches
    st, metrics = tga.run_memetic_block(
        st, OBJ, target, None, cfg, GNM, GradConfig(lr=1e-2), refine_every=5,
        refine_steps=5, num_gens=15,
    )
    m = metrics.numpy()
    assert m.shape == (15, 4)
    assert np.all(np.diff(m[:, 0]) <= 1e-9)  # best stays monotone through refinement
    assert float(st.best_fit) <= b0
    want = tobjective.evaluate(OBJ, st.best[None], target, None, device="cpu")[0]
    np.testing.assert_allclose(float(st.best_fit), float(want), rtol=1e-5, atol=1e-6)
    assert trg.lossgrad_tiles.launches == before  # CPU tensors: the plain version


def test_loss_fns_agree_and_unported_raise():
    """make_loss_fn scores with objective.evaluate's energy in both impls
    and every metric, and the unported options raise."""
    target, g = _target(3006), _pop(6, 2)
    for metric in ("mse", "ssim", "mix"):
        want = tobjective.evaluate(OBJ._replace(metric=metric), g, target, None, device="cpu")
        for impl in ("cuda", "oracle"):
            obj = OBJ._replace(impl=impl, metric=metric)
            _, fits = tgradient.make_loss_fn(obj, GNM)(g, target, None)
            np.testing.assert_allclose(fits.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
    # "fast" is ported (tests/test_torch_fast_grad.py); "bf16" is fitness-only
    with pytest.raises(NotImplementedError):
        tgradient.make_fit_step(OBJ._replace(precision="bf16"), GNM, GradConfig())
    with pytest.raises(ValueError):
        tgradient.make_fit_step(OBJ._replace(metric="psnr"), GNM, GradConfig())
    # the tile-sharded loss is ported (tests/test_torch_sharding.py); where a
    # slab is shorter than the SSIM halo it declines (None) and make_loss_fn
    # takes the unsharded loss, as gradient.py:168-171 does
    mesh = tmesh.Mesh(1, 4, 0, 0, 0, None, None, torch.device("cpu"), "gloo")
    short = OBJ._replace(H=24, W=24, metric="ssim", mesh=mesh)
    assert tgradient._make_sharded_loss_fn(short) is None


@pytest.mark.parametrize(
    "extra",
    [["--pop-shards", "2"], ["--pop-shards", "2", "--tile-shards", "2"], ["--tile-shards", "2"]],
)
def test_run_grad_unported_flags_raise(extra, tmp_path, monkeypatch):
    # sharding is ported (tests/test_torch_sharding.py); without a process
    # group the flags raise and name the torchrun launch
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        run_grad.main([
            "--image", "synthetic:24x24", "--work-max-side", "24", "--n-splats", "4",
            "--steps", "1", "--device", "cpu", "--output-dir", str(tmp_path), *extra,
        ])


def test_run_grad_cli_tiny(tmp_path):
    """python -m ggs_tpu_torch.run_grad on the CPU at a tiny size."""
    out = subprocess.run(
        [
            sys.executable, "-m", "ggs_tpu_torch.run_grad", "--image", "synthetic:40x200",
            "--work-max-side", "200", "--n-splats", "16", "--steps", "6", "--log-every", "3",
            "--device", "cpu", "--output-dir", str(tmp_path),
        ],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    assert "Final loss:" in out
    for name in ("grad_loss.csv", "grad_genome.npy", "grad_splats.png"):
        assert (tmp_path / name).exists(), name
    assert np.load(tmp_path / "grad_genome.npy").shape == (16, 9)
    rows = (tmp_path / "grad_loss.csv").read_text().strip().splitlines()
    assert len(rows) == 7 and float(rows[-1].split(",")[1]) < float(rows[1].split(",")[1])
