"""Port growth and recycling (ggs_tpu_torch/models/grow.py) against
ggs_tpu/models/grow.py on the CPU, and the invariants tests/test_grow.py
pins, on the port's own draws.

The selection is held to JAX's exactly, on JAX's own gumbel and theta
draws (replayed from split(key, 3)) and on identical residuals: both
packages' render_genomes are replaced by one canvas, since the port's
render may differ from JAX's by up to 4e-6 (ROADMAP.md §3), enough to swap
two near-equal perturbed logits. The residual's render is held to that
tolerance on its own. JAX runs on impl="xla"."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.models import grow as jgrow
from ggs_tpu.ops import objective as jobjective
from ggs_tpu_torch.models import genome as tgenome
from ggs_tpu_torch.models import grow as tgrow
from ggs_tpu_torch.ops import objective as tobjective
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 32, 160
RENDER_ATOL = 4e-6  # the port's canvases against JAX's (ROADMAP.md §3)
JOBJ = jobjective.Objective(H=H, W=W, impl="xla", precision="exact-tight")
TOBJ = tobjective.Objective(H=H, W=W, precision="exact-tight")


def _jax_draws(key, P, n_new):
    """grow_population's random numbers, replayed from its split(key, 3)."""
    _, k_pos, k_theta = jax.random.split(key, 3)
    return {
        "gumbel": torch.from_numpy(np.array(jax.random.gumbel(k_pos, (P, H * W), jnp.float32))),
        "theta": torch.from_numpy(np.array(jax.random.uniform(
            k_theta, (P, n_new), minval=-jnp.pi, maxval=jnp.pi, dtype=jnp.float32))),
    }


@pytest.fixture
def same_canvas(monkeypatch):
    """Both packages' render_genomes return one given canvas [P, H, W, 3]."""
    def use(imgs):
        monkeypatch.setattr(jgrow.objective_mod, "render_genomes",
                            lambda obj, pop: jnp.asarray(imgs))
        monkeypatch.setattr(tgrow.objective_mod, "render_genomes",
                            lambda obj, pop, device="cpu": torch.from_numpy(imgs))
    return use


def _canvas(seed, P):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (P, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_grow_population_matches_jax_on_replayed_draws(masked, same_canvas):
    P, N, n_new = 3, 10, 24
    pop = axes_genomes(60, P, N, H, W)
    tgt = image(61, H, W)
    wm = weights(62, H, W) if masked else None
    same_canvas(_canvas(63, P))
    key = jax.random.PRNGKey(64)
    ref = np.asarray(jgrow.grow_population(key, jnp.asarray(pop), n_new, jnp.asarray(tgt), JOBJ,
                                           weight_mask=None if wm is None else jnp.asarray(wm)))
    got = tgrow.grow_population(torch.from_numpy(pop), n_new, torch.from_numpy(tgt), TOBJ,
                                weight_mask=None if wm is None else torch.from_numpy(wm),
                                draws=_jax_draws(key, P, n_new)).numpy()
    assert got.shape == ref.shape == (P, N + n_new, 9)
    # the pixels, their painter order and every new gene, bit for bit
    np.testing.assert_array_equal(got, ref)


def test_grow_residual_render_matches_jax():
    pop = axes_genomes(65, 3, 16, H, W)
    ref = np.asarray(jobjective.render_genomes(JOBJ, jnp.asarray(pop)))
    got = tobjective.render_genomes(TOBJ, torch.from_numpy(pop), device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=RENDER_ATOL, rtol=0)


@pytest.mark.parametrize("k", [2, 5])
def test_recycle_with_ties_matches_jax(k, same_canvas):
    """Duplicated splats give equal impacts, so the k lowest tie: the
    survivors and their order must be JAX's (lower index pruned first)."""
    P, N = 3, 12
    pop = axes_genomes(66, P, N, H, W)
    # rows 1, 4, 7 and 9 share the lowest impact (alpha and both scales)
    for j in (4, 7, 9):
        pop[:, j, 2:4] = pop[:, 1, 2:4]
        pop[:, j, 8] = pop[:, 1, 8]
    pop[:, 1, 8] = pop[:, 4, 8] = pop[:, 7, 8] = pop[:, 9, 8] = 1.0
    pop[2, 5] = pop[2, 1]  # and a whole duplicated splat in candidate 2
    tgt = image(67, H, W)
    same_canvas(_canvas(68, P))
    key = jax.random.PRNGKey(69)
    ref = np.asarray(jgrow.recycle_population(key, jnp.asarray(pop), k, jnp.asarray(tgt), JOBJ))
    got = tgrow.recycle_population(torch.from_numpy(pop), k, torch.from_numpy(tgt), TOBJ,
                                   draws=_jax_draws(key, P, k)).numpy()
    np.testing.assert_array_equal(got, ref)
    # JAX's tie rule on a small case: top_k(-x, 3) keeps the lower index first
    x = np.array([1, 0, 0, 2, 0, 0, 3, 0], np.float32)
    _, want = jax.lax.top_k(-jnp.asarray(x), 3)
    assert torch.argsort(torch.from_numpy(x), stable=True)[:3].tolist() == [1, 2, 4] \
        == np.asarray(want).tolist()


def test_grow_keeps_painter_order_on_own_draws():
    P, N = 3, 8
    pop = tgenome.new_population(torch.Generator().manual_seed(70), P, N, H, W, 1.0, 0.3, "cpu")
    out = tgrow.grow_population(pop, 5, torch.zeros((H, W, 3)), TOBJ,
                                rng=torch.Generator().manual_seed(71))
    assert tuple(out.shape) == (P, N + 5, 9)
    # originals unchanged and first: the new splats are painted on top
    assert torch.equal(out[:, :N], pop)
    d = tgrow.draw_grow(torch.Generator().manual_seed(72), P, 5, H, W)
    assert tuple(d["gumbel"].shape) == (P, H * W) and tuple(d["theta"].shape) == (P, 5)
    assert bool(torch.isfinite(d["gumbel"]).all())
    assert float(d["theta"].min()) >= -np.pi and float(d["theta"].max()) <= np.pi


def test_grow_lands_on_distinct_high_residual_pixels():
    """With a transparent population the residual is |background - target|:
    the new splats land in the dark box on distinct pixels and copy its
    colour (own draws)."""
    P, n_new = 2, 16
    pop = tgenome.new_population(torch.Generator().manual_seed(73), P, 4, H, W, 1.0, 0.3, "cpu")
    pop[..., 8] = 0.0  # fully transparent: the render is the white background
    target = torch.ones((H, W, 3))
    target[8:16, 20:28] = torch.tensor([0.1, 0.2, 0.3])
    out = tgrow.grow_population(pop, n_new, target, TOBJ, rng=torch.Generator().manual_seed(74))
    new = out[:, 4:].numpy()
    px, py = new[..., 0] * (W - 1), new[..., 1] * (H - 1)
    inside = (px >= 19.5) & (px <= 27.5) & (py >= 7.5) & (py <= 15.5)
    assert inside.mean() > 0.95
    np.testing.assert_allclose(new[..., 5], 0.1 * 255.0, atol=1e-4)
    for i in range(P):
        pix = set(zip(np.rint(px[i]).astype(int).tolist(), np.rint(py[i]).astype(int).tolist()))
        assert len(pix) == n_new


def test_recycle_prunes_lowest_impact_on_own_draws():
    P, N, k = 2, 8, 2
    pop = tgenome.new_population(torch.Generator().manual_seed(75), P, N, H, W, 1.0, 0.3, "cpu")
    pop[:, 3, 8] = 0.01
    pop[:, 3, 2:4] = 0.0
    out = tgrow.recycle_population(pop, k, torch.zeros((H, W, 3)), TOBJ,
                                   rng=torch.Generator().manual_seed(76))
    assert out.shape == pop.shape
    surv, orig = out[:, : N - k].numpy(), pop.numpy()
    for p in range(P):
        assert not any(np.allclose(row, orig[p, 3]) for row in surv[p])
        idxs = [int(np.argmin(np.abs(orig[p] - row).sum(axis=1))) for row in surv[p]]
        assert idxs == sorted(idxs)
    with pytest.raises(ValueError):
        tgrow.recycle_population(pop, N, torch.zeros((H, W, 3)), TOBJ,
                                 rng=torch.Generator().manual_seed(77))
