"""Port objective, state conversion and runner (ggs_tpu_torch/ops/objective.py,
convert.py, run_ga.py) against the JAX package on the CPU. Fitness within
rtol 5e-5 (tests/test_render_pallas.py:140)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import objective as jobjective
from ggs_tpu.utils import checkpoint as jcheckpoint
from ggs_tpu.utils import io as jio
from ggs_tpu_torch import convert, run_ga
from ggs_tpu_torch.config import GAConfig as TGAConfig
from ggs_tpu_torch.config import GenomeConfig as TGenomeConfig
from ggs_tpu_torch.config import MutSigma
from ggs_tpu_torch.models import ga as tga
from ggs_tpu_torch.ops import objective as tobjective
from ggs_tpu_torch.utils import io as tio
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 40, 200


@pytest.mark.parametrize(
    "precision,chunk,boost", [("exact-tight", 3, False), ("highest", None, True)]
)
def test_evaluate_matches(precision, chunk, boost):
    """evaluate() with chunk not dividing B (B=5, chunk=3) vs the JAX
    package's evaluate on its Pallas path (interpret mode)."""
    g = axes_genomes(20, 5, 16, H, W)
    tgt, wm = image(20, H, W), weights(20, H, W)
    jobj = jobjective.Objective(
        H=H, W=W, impl="pallas", interpret=True, chunk=chunk, precision=precision,
        boost_only=boost,
    )
    tobj = tobjective.Objective(H=H, W=W, chunk=chunk, precision=precision, boost_only=boost)
    ref = jobjective.evaluate(jobj, jnp.asarray(g), jnp.asarray(tgt), jnp.asarray(wm))
    got = tobjective.evaluate(tobj, g, tgt, wm, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5)
    dense = tobjective.evaluate(tobj._replace(impl="oracle"), g, tgt, wm, device="cpu")
    np.testing.assert_allclose(dense.numpy(), got.numpy(), rtol=5e-5)


def test_render_genomes_matches():
    g = axes_genomes(21, 2, 16, H, W)
    jobj = jobjective.Objective(H=H, W=W, impl="xla", precision="exact-tight")
    tobj = tobjective.Objective(H=H, W=W, precision="exact-tight")
    for exact in (False, True):
        ref = jobjective.render_genomes(jobj, jnp.asarray(g), exact=exact)
        got = tobjective.render_genomes(tobj, g, exact=exact, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=4e-6)


def test_state_carried_across_and_checkpoint(tmp_path):
    """A population scored by JAX evaluate scores the same in the port after
    ga_state_from_jax, and a JAX save_checkpoint file loads with numpy."""
    from ggs_tpu.config import GAConfig, GenomeConfig
    from ggs_tpu.models import ga as jga

    tgt, wm = image(22, H, W), weights(22, H, W)
    jobj = jobjective.Objective(H=H, W=W, impl="xla", precision="exact-tight")
    cfg, gnm = GAConfig(pop_size=6, elite_k=2), GenomeConfig(n_splats=16)
    js = jga.init(jax.random.PRNGKey(3), jobj, jnp.asarray(tgt), jnp.asarray(wm), cfg, gnm)
    path = str(tmp_path / "ga_ckpt.npz")
    jcheckpoint.save_checkpoint(path, js, meta={"gen": 0})
    leaves, meta = convert.load_jax_checkpoint(path)
    assert meta == {"gen": 0}
    ts = convert.ga_state_from_jax(leaves, device="cpu")
    np.testing.assert_array_equal(ts.pop.numpy(), np.asarray(js.pop))
    assert float(ts.best_fit) == float(js.best_fit) and ts.gen == 0
    tobj = tobjective.Objective(H=H, W=W, precision="exact-tight")
    fits = tobjective.evaluate(tobj, ts.pop, tgt, wm, device="cpu")
    np.testing.assert_allclose(fits.numpy(), np.asarray(js.fits), rtol=5e-5)
    # the port's GA continues from the carried state
    ts2, m = tga.step(
        ts, tobj, torch.from_numpy(tgt), torch.from_numpy(wm),
        TGAConfig(pop_size=6, elite_k=2), TGenomeConfig(n_splats=16),
        MutSigma.max_defaults().__dict__, MutSigma.min_defaults().__dict__,
    )
    assert ts2.gen == 1 and float(m[0]) <= float(ts.best_fit)


def test_no_fallback_without_a_card():
    """Asking for the card where there is none raises; nothing falls back to
    the CPU unless asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    g = axes_genomes(23, 2, 8, H, W)
    tobj = tobjective.Objective(H=H, W=W)
    with pytest.raises(RuntimeError, match="cuda"):
        tobjective.evaluate(tobj, g, image(23, H, W))
    with pytest.raises(RuntimeError, match="cuda"):
        run_ga.main(["--image", "synthetic:40x200", "--generations", "1", "--no-video"])


def test_synthetic_target_and_ensure_hw():
    np.testing.assert_array_equal(tio.synthetic_target(40, 56), jio.synthetic_target(40, 56))
    t = tio.load_image("synthetic:24x30")
    ref = jio.ensure_hw(jnp.asarray(t * 255.0), 12, 15)
    got = tio.ensure_hw(t * 255.0, 12, 15, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(tio.load_image("photo:24x30"), jio.load_image("photo:24x30"))


def test_run_ga_cpu_end_to_end(tmp_path):
    """The runner on the CPU at a tiny size: best falls, artifacts written,
    the SSIM metrics run, frames are written by default (the fast tiers run:
    tests/test_torch_fast_grad.py)."""
    out = run_ga.main([
        "--image", "synthetic:40x200", "--work-max-side", "200", "--n-splats", "16",
        "--pop-size", "6", "--elite-k", "2", "--generations", "8", "--log-every", "4",
        "--no-video", "--device", "cpu", "--output-dir", str(tmp_path),
    ])
    best = out["curves"]["best"]
    assert len(best) == 9 and best[-1] <= best[0]
    assert out["final"].shape == (40, 200, 3)
    assert (tmp_path / "ga_splats.png").exists() and (tmp_path / "ga_loss.csv").exists()
    assert np.load(tmp_path / "ga_best_genome.npy").shape == (16, 9)
    base = ["--image", "synthetic:40x200", "--device", "cpu", "--generations", "1"]
    small = ["--n-splats", "8", "--pop-size", "4", "--elite-k", "1", "--log-every", "1"]
    run_ga.main(base + small + ["--output-dir", str(tmp_path / "video")])  # frames by default
    assert (tmp_path / "video" / "ga_anim.apng").exists()
    for extra in (["--metric", "mix", "--ssim-weight", "0.3"], ["--metric", "ssim"]):
        out = run_ga.main(base + small + ["--no-video", "--output-dir", str(tmp_path)] + extra)
        assert 0.0 < out["best_fit"] < 1.0 and len(out["curves"]["best"]) == 2
