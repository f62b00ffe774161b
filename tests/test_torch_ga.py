"""Port GA (ggs_tpu_torch/models) against ggs_tpu/models on replayed draws.

jax.random streams cannot be reproduced by torch generators, so these
tests rebuild the JAX function's own random numbers by replaying its key
splits (ga.step -> split(key); ga._offspring -> split(key, 5);
operators.mutate_population -> split(key, P); mutate_individual ->
split(key, 14); _zorder_swap -> split(key)) and hand them to the port's
deterministic apply functions. Populations agree within atol 1e-6 (the
clamp bounds and wrap go through float32 log/fmod in each package),
fitness within rtol 5e-5 (tests/test_render_pallas.py:140). The JAX side
scores with impl="xla" at precision "exact-tight" (its oracle, exact to
its Pallas path by the JAX suite's own tests); the port scores through its
K1 path, which takes the kernel's plain version on the CPU. The port's
own draws are checked against the invariants test_operators.py and
test_ga.py pin."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.config import GAConfig as JGAConfig
from ggs_tpu.config import GenomeConfig as JGenomeConfig
from ggs_tpu.models import ga as jga
from ggs_tpu.models import genome as jgenome
from ggs_tpu.ops import objective as jobjective
from ggs_tpu_torch import convert
from ggs_tpu_torch.config import GAConfig, GenomeConfig, MutSigma
from ggs_tpu_torch.models import ga as tga
from ggs_tpu_torch.models import genome as tgenome
from ggs_tpu_torch.models import operators as tops
from ggs_tpu_torch.ops import objective as tobjective
from torch_inputs import image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 32, 160
SIG_MAX = MutSigma.max_defaults().__dict__
SIG_MIN = MutSigma.min_defaults().__dict__


def _t(x, dtype=None):
    a = np.array(x)
    t = torch.from_numpy(a)
    return t.long() if a.dtype.kind in "iu" and dtype is None else t


def jax_mutation_draws(k_mut, P, N):
    """mutate_population's random numbers, stacked over the population."""
    return jax_mutation_draws_from_keys(jax.random.split(k_mut, P), N)


def jax_mutation_draws_from_keys(keys, N):
    """mutate_individual's random numbers for each key, stacked."""
    rows = []
    for key in keys:
        ks = jax.random.split(key, 14)
        k_i, k_j = jax.random.split(ks[13])
        u = jax.random.uniform
        n = jax.random.normal
        ri = jax.random.randint
        rows.append({
            "u_xy": u(ks[0], (N, 2)), "u_ab": u(ks[1], (N, 2)), "u_t": u(ks[2], (N, 1)),
            "u_rgb": u(ks[3], (N, 1)), "u_a": u(ks[4], (N, 1)),
            "r_pair": ri(ks[5], (), 0, 2 * N), "r_xy": ri(ks[6], (), 0, 2 * N),
            "r_ab": ri(ks[7], (), 0, 2 * N), "r_t": ri(ks[8], (), 0, N),
            "n_xy": n(ks[9], (N, 2)), "n_ab": n(ks[10], (N, 2)), "n_t": n(ks[11], (N, 1)),
            "n_rgba": n(ks[12], (N, 4)),
            "z_i": ri(k_i, (), 0, N - 1), "z_u": u(k_j, (N,)),
        })
    return {k: _t(np.stack([np.asarray(r[k]) for r in rows])) for k in rows[0]}


def jax_offspring_draws(k_off, P, N, tour_k):
    """ga._offspring's random numbers."""
    k_sel, k_shuf, k_cx, k_cxm, k_mut = jax.random.split(k_off, 5)
    return {
        "sel": _t(jax.random.randint(k_sel, (P, tour_k), 0, P)),
        "perm": _t(jax.random.permutation(k_shuf, P)),
        "u_cx": _t(jax.random.uniform(k_cx, (P // 2, 1, 1)).reshape(P // 2)),
        "u_cxm": _t(jax.random.uniform(k_cxm, (P // 2, N, 1)).reshape(P // 2, N)),
        "mut": jax_mutation_draws(k_mut, P, N),
    }


def test_new_population_on_jax_draws():
    B, N, key = 3, 20, jax.random.PRNGKey(11)
    k_xy, k_a, k_b, k_t, k_rgb, k_al = jax.random.split(key, 6)
    draws = {
        "xy": jax.random.uniform(k_xy, (B, N, 2)),
        "u_a": jax.random.beta(k_a, *tgenome._beta_params(0.4), shape=(B, N, 1)),
        "u_b": jax.random.beta(k_b, *tgenome._beta_params(0.6), shape=(B, N, 1)),
        "theta": jax.random.uniform(k_t, (B, N, 1), minval=-math.pi, maxval=math.pi),
        "rgb": jax.random.uniform(k_rgb, (B, N, 3), minval=0.0, maxval=256.0),
        "alpha": jax.random.uniform(k_al, (B, N, 1), minval=180.0, maxval=256.0),
    }
    got = tgenome.apply_population({k: _t(v) for k, v in draws.items()}, H, W, 3.0, 0.1)
    ref = jgenome.new_population(key, B, N, H, W, 3.0, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)

    # the port's own draws land in the same domain
    gen = torch.Generator().manual_seed(0)
    pop = tgenome.new_population(gen, 4, 64, H, W, device="cpu")
    p = pop.numpy()
    assert p.shape == (4, 64, 9)
    assert p[..., 0:2].min() >= 0.0 and p[..., 0:2].max() <= 1.0
    lo, hi = np.log(3.0), np.log(0.1 * max(H, W))
    assert p[..., 2:4].min() >= lo - 1e-6 and p[..., 2:4].max() <= hi + 1e-6
    assert np.abs(p[..., 4]).max() <= np.pi
    assert p[..., 5:8].min() >= 0.0 and p[..., 8].min() >= 180.0 and p[..., 5:9].max() <= 255.0


@pytest.mark.parametrize("kind", ["cosine", "linear", "exp"])
def test_anneal_and_sigma_match(kind):
    for g in (0, 1, 7, 50, 99, 100, 150):
        ref = float(jgenome.anneal_factor(jnp.int32(g), 100, kind))
        assert tgenome.anneal_factor(g, 100, kind) == pytest.approx(ref, rel=1e-6, abs=1e-7)
        rs = jgenome.build_mut_sigma(jnp.int32(g), 100, kind, SIG_MAX, SIG_MIN)
        ts = tgenome.build_mut_sigma(g, 100, kind, SIG_MAX, SIG_MIN)
        for k in SIG_MAX:
            assert ts[k] == pytest.approx(float(rs[k]), rel=1e-6)


@pytest.mark.parametrize("gens", [1, 3])
def test_ga_step_matches_on_replayed_draws(gens):
    """One generation, then three (the slice as a whole): offspring, the new
    population and its fits, elites and [best, mean, median, no_improve]."""
    P, N = 8, 12
    jcfg = JGAConfig(pop_size=P, generations=20, elite_k=2, cxpb=0.5, mutpb=0.2)
    tcfg = GAConfig(pop_size=P, generations=20, elite_k=2, cxpb=0.5, mutpb=0.2)
    jgnm = JGenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
    tgnm = GenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
    jobj = jobjective.Objective(H=H, W=W, impl="xla", precision="exact-tight")
    tobj = tobjective.Objective(H=H, W=W, precision="exact-tight")
    tgt, wm = image(12, H, W), weights(12, H, W)
    tgt_t, wm_t = torch.from_numpy(tgt), torch.from_numpy(wm)

    js = jga.init(jax.random.PRNGKey(5), jobj, jnp.asarray(tgt), jnp.asarray(wm), jcfg, jgnm)
    ts = convert.ga_state_from_jax([np.array(x) for x in jax.tree.flatten(js)[0]], device="cpu")
    # the carried-across population scores the same in the port
    fits0 = tobjective.evaluate(tobj, ts.pop, tgt_t, wm_t, device="cpu")
    np.testing.assert_allclose(fits0.numpy(), np.asarray(js.fits), rtol=5e-5)

    for _ in range(gens):
        _, k_off = jax.random.split(js.key)
        draws = jax_offspring_draws(k_off, P, N, jcfg.tour_k)
        j_off = jga._offspring(
            k_off, js.pop, js.fits, jcfg, js.gen + 1, jobj, jgnm, SIG_MAX, SIG_MIN
        )
        t_off = tga._offspring(
            ts.pop, ts.fits, draws, tcfg, ts.gen + 1, tobj, tgnm, SIG_MAX, SIG_MIN
        )
        np.testing.assert_allclose(t_off.numpy(), np.asarray(j_off), atol=1e-6)

        js, jm = jga.step(js, jobj, jnp.asarray(tgt), jnp.asarray(wm), jcfg, jgnm, SIG_MAX, SIG_MIN)
        ts, tm = tga.step(ts, tobj, tgt_t, wm_t, tcfg, tgnm, SIG_MAX, SIG_MIN, draws=draws)
        np.testing.assert_allclose(ts.pop.numpy(), np.asarray(js.pop), atol=1e-6)
        np.testing.assert_allclose(ts.fits.numpy(), np.asarray(js.fits), rtol=5e-5)
        np.testing.assert_allclose(ts.best.numpy(), np.asarray(js.best), atol=1e-6)
        np.testing.assert_allclose(tm[:3].numpy(), np.asarray(jm[:3]), rtol=5e-5)
        assert int(tm[3]) == int(jm[3]) == int(ts.no_improve)
        assert ts.gen == int(js.gen)


def test_mutation_invariants():
    """>= 1 mutated gene per group even at mutpb=0, clamping, and the z-order
    swap moving a strictly larger later splat earlier (genetic.py:47-91)."""
    P, N = 6, 32
    gen = torch.Generator().manual_seed(3)
    pop = tgenome.new_population(gen, P, N, 64, 64, device="cpu")
    sig = {k: 10.0 for k in SIG_MAX}
    out = tops.apply_mutation(
        pop, tops.draw_mutation(gen, P, N, "cpu"), sig, 0.0, 64, 64, 3.0, 0.1
    ).numpy()
    d = out - pop.numpy()
    for cols in ([0, 1], [2, 3], [4], [5, 6, 7, 8]):
        assert np.all(np.abs(d[:, :, cols]).sum(axis=(1, 2)) > 0), cols

    big = {k: 100.0 for k in SIG_MAX}
    o = tops.apply_mutation(
        pop, tops.draw_mutation(gen, P, N, "cpu"), big, 1.0, 32, 32, 3.0, 0.1
    ).numpy()
    assert o[..., 0:2].min() >= 0.0 and o[..., 0:2].max() <= 1.0
    lo, hi = np.log(3.0), np.log(0.1 * 32)
    assert o[..., 2:4].min() >= lo - 1e-5 and o[..., 2:4].max() <= hi + 1e-5
    assert o[..., 4].min() > -np.pi - 1e-6 and o[..., 4].max() <= np.pi + 1e-6
    assert o[..., 5:9].min() >= 0.0 and o[..., 5:9].max() <= 255.0

    swaps = 0
    for trial in range(10):
        g = tgenome.new_population(gen, 4, 16, 64, 64, device="cpu")
        z_i = torch.randint(0, 15, (4,), generator=gen)
        z_u = torch.rand((4, 16), generator=gen)
        s = tops._zorder_swap(g, z_i, z_u)
        for a, b in zip(g.numpy(), s.numpy()):
            np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])
            rows = np.nonzero(np.any(a != b, axis=1))[0]
            if len(rows):
                swaps += 1
                i, j = rows
                area = np.exp(a[:, 2]) * np.exp(a[:, 3])
                assert area[j] > area[i]
                np.testing.assert_array_equal(b[i], a[j])
    assert swaps > 0


def test_tournament_and_elites_on_own_draws():
    gen = torch.Generator().manual_seed(4)
    fits = torch.tensor([5.0, 1.0, 3.0, 4.0, 2.0])
    win = tops.apply_tournament(fits, tops.draw_tournament(gen, 5, 64, 32, "cpu"))
    assert int((win == 1).sum()) >= 60
    # ties go to the earliest entrant
    assert tops.apply_tournament(torch.tensor([1.0, 1.0]), torch.tensor([[1, 0]])).item() == 1

    P, N = 6, 8
    cfg = GAConfig(pop_size=P, generations=30, elite_k=2, cxpb=0.3, mutpb=0.3)
    gnm = GenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
    obj = tobjective.Objective(H=24, W=24, precision="exact-tight")
    tgt = torch.from_numpy(image(13, 24, 24))
    st = tga.init(torch.Generator().manual_seed(1), obj, tgt, None, cfg, gnm)
    prev = float(st.fits.min())
    for _ in range(4):
        old = st
        st, m = tga.step(st, obj, tgt, None, cfg, gnm, SIG_MAX, SIG_MIN)
        # the E best of the previous population are carried over, in order
        order = torch.sort(old.fits, stable=True).indices[:2]
        np.testing.assert_array_equal(st.pop[:2].numpy(), old.pop[order].numpy())
        assert float(st.fits.min()) <= prev + 1e-7
        assert float(m[0]) <= float(m[1]) + 1e-7
        prev = float(st.fits.min())
