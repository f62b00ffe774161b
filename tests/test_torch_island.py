"""Port island GA (ggs_tpu_torch/parallel/island.py) against
ggs_tpu/parallel/island.py (its mesh-free branch) on replayed draws, on the
CPU.

jax.random streams cannot be reproduced by torch generators, so the tests
rebuild island.step's random numbers from its key splits (split(key, 7) ->
key, k_sel, k_shuf, k_cx, k_cxm, k_mut, k_mig; the mutation's split(k_mut,
P) as tests/test_torch_ga.py replays it) and hand them to the port's step
as `draws`. The pieces are held on their own: the tournament's winners, the
shuffle and the migration's slots equal, on fits with ties (lax.top_k and
jnp.argsort keep the lower index first among equal values; the port takes
stable sorts). Whole generations run twice: on the real energies (JAX's
impl="xla", the port's K1 plain version: fits within rtol 5e-5,
tests/test_render_pallas.py:140) from a population with clones, so tied
fits, and on an energy with many ties that both packages compute the same
(objective.evaluate replaced in each by the count of splats with alpha above
128, asserted clear of 128 by 1e-3 so no genome ulp flips a count). Genomes
are held to rtol 2e-6 / atol 1e-6, the tolerance of the SA/PT steps
(ROADMAP §3): JAX rounds its mutation a few ulps apart from the port's. One
island equals the port's ga.step on the same draws, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.config import GAConfig as JGAConfig
from ggs_tpu.config import GenomeConfig as JGenomeConfig
from ggs_tpu.models import ga as jga
from ggs_tpu.ops import objective as jobjective
from ggs_tpu.parallel import island as jisland
from ggs_tpu_torch import convert
from ggs_tpu_torch.config import GAConfig, GenomeConfig, MutSigma
from ggs_tpu_torch.models import ga as tga
from ggs_tpu_torch.ops import objective as tobjective
from ggs_tpu_torch.parallel import island as tisland
from test_torch_ga import jax_mutation_draws
from torch_inputs import image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, N, P = 24, 40, 8, 16
SIG_MAX = MutSigma.max_defaults().__dict__
SIG_MIN = MutSigma.min_defaults().__dict__
JGNM = JGenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
TGNM = GenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
JOBJ = jobjective.Objective(H=H, W=W, impl="xla", precision="exact-tight")
TOBJ = tobjective.Objective(H=H, W=W, precision="exact-tight")
CFG = dict(pop_size=P, generations=30, elite_k=2, cxpb=0.5, mutpb=0.3)
ENERGY_RTOL = 5e-5
JIT_RTOL = 2e-6


def _t(x):
    a = np.array(x)
    return torch.from_numpy(a).long() if a.dtype.kind in "iu" else torch.from_numpy(a)


def jax_island_draws(key, I, S, tour_k):
    """island.step's random numbers (island.py:88-111)."""
    _, k_sel, k_shuf, k_cx, k_cxm, k_mut, _ = jax.random.split(key, 7)
    return {
        "sel": _t(jax.random.randint(k_sel, (I, S, tour_k), 0, S)),
        "u_shuf": _t(jax.random.uniform(k_shuf, (I, S))),
        "u_cx": _t(jax.random.uniform(k_cx, (I, S // 2, 1, 1)).reshape(I, S // 2)),
        "u_cxm": _t(jax.random.uniform(k_cxm, (I, S // 2, N, 1)).reshape(I, S // 2, N)),
        "mut": jax_mutation_draws(k_mut, I * S, N),
    }


def _tied_fits(seed, I, S):
    """[I, S] fits drawn from a few values, so every island holds ties."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0.5, 0.25, 0.75, 0.125], np.float32), size=(I, S))


@pytest.mark.parametrize("I,S,k", [(2, 8, 2), (4, 4, 3)])
def test_island_tournament_matches_jax(I, S, k):
    fits = _tied_fits(1, I, S)
    key = jax.random.PRNGKey(3)
    want = jisland._island_tournament(key, jnp.asarray(fits), k)
    idx = _t(jax.random.randint(key, (I, S, k), 0, S))
    got = tisland._island_tournament(torch.from_numpy(fits), idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() >= 0 and got.max() < S


@pytest.mark.parametrize("I,S", [(2, 8), (4, 4)])
def test_island_shuffle_matches_jax(I, S):
    x = np.arange(I * S * 3, dtype=np.float32).reshape(I, S, 3, 1)
    key = jax.random.PRNGKey(4)
    want = jisland._island_shuffle(key, jnp.asarray(x))
    u = _t(jax.random.uniform(key, (I, S)))
    got = tisland._island_shuffle(torch.from_numpy(x), u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ties in the uniforms keep the lower index first, as jnp.argsort does
    u_tied = torch.zeros((I, S))
    np.testing.assert_array_equal(tisland._island_shuffle(torch.from_numpy(x), u_tied).numpy(), x)


@pytest.mark.parametrize("I,k", [(2, 1), (2, 3), (4, 2)])
def test_migrate_roll_matches_jax(I, k):
    """Migrants and the slots they fill equal JAX's on fits with ties."""
    S = P // I
    fits = _tied_fits(2 + I + k, I, S).reshape(P)
    pop = np.random.default_rng(5).standard_normal((P, N, 9)).astype(np.float32)
    jp, jf = jisland._migrate_roll(jnp.asarray(pop), jnp.asarray(fits), k, I)
    tp, tf = tisland._migrate_roll(torch.from_numpy(pop), torch.from_numpy(fits), k, I)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def _alpha_count(g):
    return (g[..., 8] > 128.0).sum(-1)


def _tie_energies(monkeypatch, seen):
    """objective.evaluate in both packages: the count of splats with alpha
    above 128, over N (a handful of values, so fits tie)."""

    def jfake(obj, g, target, weight_mask=None, **kw):
        seen.append(np.asarray(g))
        return _alpha_count(jnp.asarray(g)).astype(jnp.float32) / N

    def tfake(obj, g, target, weight_mask=None, **kw):
        return _alpha_count(g).to(torch.float32) / N

    monkeypatch.setattr(jobjective, "evaluate", jfake)
    monkeypatch.setattr(tobjective, "evaluate", tfake)


def _clone_pop(js, stride):
    """JAX's initial population with every `stride`-th candidate copied
    into its neighbour: equal fits on both sides."""
    pop = np.array(js.pop)
    pop[1::stride] = pop[0::stride][: len(pop[1::stride])]
    return js._replace(pop=jnp.asarray(pop))


@pytest.mark.parametrize("energy", ["real", "ties"])
@pytest.mark.parametrize("I,migrate_every,migrate_k", [(2, 1, 2), (4, 2, 1)])
def test_island_steps_match_jax(monkeypatch, energy, I, migrate_every, migrate_k):
    """Several island generations, migration on, against JAX's island.step on
    its own draws: the population, fits, best and [best, mean, median,
    no_improve] each generation."""
    S = P // I
    jcfg, tcfg = JGAConfig(**CFG), GAConfig(**CFG)
    tgt, wm = image(21, H, W), weights(22, H, W)
    jt, jw = jnp.asarray(tgt), jnp.asarray(wm)
    tt, tw = torch.from_numpy(tgt), torch.from_numpy(wm)
    seen = []
    if energy == "ties":
        _tie_energies(monkeypatch, seen)
    js = jga.init(jax.random.PRNGKey(8), JOBJ, jt, jw, jcfg, JGNM)
    js = _clone_pop(js, 3)
    js = js._replace(fits=jobjective.evaluate(JOBJ, js.pop, jt, jw))
    ts = convert.ga_state_from_jax([np.array(x) for x in jax.tree.flatten(js)[0]], device="cpu")
    tie_counts = []
    for _ in range(4):
        draws = jax_island_draws(js.key, I, S, jcfg.tour_k)
        js, jm = jisland.step(js, JOBJ, jt, jw, jcfg, JGNM, SIG_MAX, SIG_MIN, I,
                              migrate_every, migrate_k)
        ts, tm = tisland.step(ts, TOBJ, tt, tw, tcfg, TGNM, SIG_MAX, SIG_MIN, I,
                              migrate_every, migrate_k, draws=draws)
        np.testing.assert_allclose(ts.pop.numpy(), np.asarray(js.pop), rtol=JIT_RTOL, atol=1e-6)
        np.testing.assert_allclose(ts.fits.numpy(), np.asarray(js.fits), rtol=ENERGY_RTOL)
        np.testing.assert_allclose(ts.best.numpy(), np.asarray(js.best), rtol=JIT_RTOL, atol=1e-6)
        np.testing.assert_allclose(tm[:3].numpy(), np.asarray(jm[:3]), rtol=ENERGY_RTOL)
        assert int(tm[3]) == int(jm[3]) == int(ts.no_improve) and ts.gen == int(js.gen)
        f = np.asarray(js.fits).reshape(I, S)
        tie_counts.append(sum(len(row) - len(np.unique(row)) for row in f))
    assert sum(tie_counts) > 0  # the elites, migrants and worst slots met ties
    if energy == "ties":  # no alpha within reach of a genome ulp of the threshold
        assert min(np.abs(g[..., 8] - 128.0).min() for g in seen) > 1e-3


@pytest.mark.parametrize("blur", [None, 1.5])
def test_one_island_equals_ga_step(blur):
    """n_islands = 1 is models/ga.step on the same draws (the shuffle's
    permutation being the stable argsort of its uniforms), bit for bit."""
    cfg = GAConfig(pop_size=8, generations=20, elite_k=2, cxpb=0.5, mutpb=0.3)
    tt, tw = torch.from_numpy(image(31, H, W)), torch.from_numpy(weights(32, H, W))
    sigma = None if blur is None else torch.tensor(blur)
    st = tga.init(torch.Generator().manual_seed(2), TOBJ, tt, tw, cfg, TGNM)
    rng = torch.Generator().manual_seed(9)
    a = b = st
    for _ in range(3):
        d = tisland.draw_island(rng, 1, 8, N, cfg.tour_k, "cpu")
        gd = {"sel": d["sel"][0], "perm": torch.argsort(d["u_shuf"][0], stable=True),
              "u_cx": d["u_cx"][0], "u_cxm": d["u_cxm"][0], "mut": d["mut"]}
        a, ma = tisland.step(a, TOBJ, tt, tw, cfg, TGNM, SIG_MAX, SIG_MIN, 1, draws=d,
                             blur_sigma=sigma)
        b, mb = tga.step(b, TOBJ, tt, tw, cfg, TGNM, SIG_MAX, SIG_MIN, draws=gd,
                         blur_sigma=sigma)
        for x, y in zip(a[:5], b[:5]):
            assert torch.equal(x, y)
        assert torch.equal(ma, mb) and a.gen == b.gen


def test_deme_checks_and_exclusions():
    gnm = TGNM
    with pytest.raises(ValueError, match="divide into n_islands"):
        tisland.make_run_block(TOBJ, GAConfig(pop_size=10), gnm, 3)
    with pytest.raises(ValueError, match="even size"):
        tisland.make_run_block(TOBJ, GAConfig(pop_size=12), gnm, 4)
    with pytest.raises(ValueError, match="migrate_k"):
        tisland.make_run_block(TOBJ, GAConfig(pop_size=8), gnm, 2, migrate_every=1, migrate_k=5)
    tgt = image(41, H, W)
    for extra in ({"memetic_every": 2}, {"anneal_sigma0": 2.0}):
        with pytest.raises(ValueError, match="single-deme"):
            tga.genetic_approx(tgt, H, W, obj=TOBJ, ga=GAConfig(pop_size=8, generations=2),
                               gnm=gnm, n_islands=2, device="cpu", **extra)


def test_island_block_keeps_best_monotone():
    """The port's own draws: a block improves on the start and its best
    curve never rises; migration keeps each deme's size."""
    cfg = GAConfig(pop_size=16, generations=40, elite_k=2, cxpb=0.3, mutpb=0.2)
    tt = torch.from_numpy(image(51, H, W))
    st = tga.init(torch.Generator().manual_seed(3), TOBJ, tt, None, cfg, TGNM)
    b0 = float(st.best_fit)
    run = tisland.make_run_block(TOBJ, cfg, TGNM, 4, migrate_every=5, migrate_k=1)
    st, m = run(st, tt, None, 20)
    m = m.numpy()
    assert m.shape == (20, 4) and np.all(np.isfinite(m))
    assert np.all(np.diff(m[:, 0]) <= 0.0) and m[-1, 0] < b0
    assert tuple(st.pop.shape) == (16, N, 9) and st.gen == 20
