"""The port's memetic and island run blocks (ga.make_memetic_run_block,
island.make_run_block) and the refinement they hold (gradient.make_refine),
on the CPU at a small size (24x24, N=6), where every kernel wrapper takes
its plain version and a block runs its eager body.

* Each block, over blocks of 4, 4 and 3, equals the old eager loop of
  host-scalar steps in bits (state, metrics and the generator's state): the
  memetic block with a refinement inside a block (refine_every 3) and on a
  block's last generation (refine_every 4), at the default and at other
  mutation sigmas; the island block with migrations inside and on a block's
  last generation.
* island.step reading its sigma row on the device equals its host-scalar
  form in bits, as ga.step does (test_torch_run_blocks.py).
* The refinement built once (make_refine), fresh and reused on other elites
  first, equals refine_elites in bits, and against JAX's refine_elites
  (impl="xla", under jax.jit) stays within test_torch_run_blocks.py's
  carried-state Adam tolerances (fits rtol 1e-5, genomes atol 1e-5 and
  2e-5 on the 0-255 columns) with the same accept decisions.
* genetic_approx's sig_max / sig_min reach the plain, memetic and island
  blocks: the first generation mutates at build_mut_sigma of those sigmas
  and the run equals the host-scalar steps with them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.config import GenomeConfig as JGenomeConfig
from ggs_tpu.config import GradConfig as JGradConfig
from ggs_tpu.models import gradient as jgradient
from ggs_tpu.ops import objective as jobjective
from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig, MutSigma
from ggs_tpu_torch.models import ga, genome, gradient, operators
from ggs_tpu_torch.ops import objective
from ggs_tpu_torch.parallel import island
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H = W = 24
GNM = GenomeConfig(n_splats=6, min_scale=1.0, max_scale=0.3)
OBJ = objective.Objective(H=H, W=W, precision="exact-tight")
TGT = torch.from_numpy(image(21, H, W))
WM = torch.from_numpy(weights(22, H, W))
BLOCKS = (4, 4, 3)  # three blocks, the last shorter
GRAD = GradConfig(lr=2e-2)
REFINE_STEPS = 2
# sigmas other than MutSigma's defaults
OTHER_MAX = MutSigma(xy=0.3, alog=0.9, blog=0.7, theta=0.6, rgb=60.0, alpha=40.0)
OTHER_MIN = MutSigma(xy=0.05, alog=0.2, blog=0.1, theta=0.1, rgb=10.0, alpha=8.0)
SIGMAS = {"default": (None, None), "other": (OTHER_MAX, OTHER_MIN)}


def _rng(seed=5):
    return torch.Generator().manual_seed(seed)


def _dicts(sig_max, sig_min):
    return ((sig_max or MutSigma.max_defaults()).__dict__,
            (sig_min or MutSigma.min_defaults()).__dict__)


def _same(a, b):
    """Two GAStates equal in bits, the generation and generator included."""
    return (all(torch.equal(x, y) for x, y in zip(a[:5], b[:5])) and a.gen == b.gen
            and torch.equal(a.rng.get_state(), b.rng.get_state()))


def _blocks(run, state):
    out = []
    for n in BLOCKS:
        state, m = run(state, TGT, WM, n)
        out.append(m)
    return state, torch.cat(out)


def _ga_cfg(pop_size=6, generations=9):
    return GAConfig(pop_size=pop_size, generations=generations, elite_k=2, cxpb=0.5, mutpb=0.3)


def _refine_elites(obj=OBJ, gnm=GNM):
    """refine_elites, a fresh Adam each call: the eager loop's refinement."""
    return lambda el, ef, t, w: gradient.refine_elites(el, ef, t, w, obj, gnm, GRAD,
                                                       REFINE_STEPS)


def _memetic_loop(st, cfg, refine_every, n, sig_max, sig_min, obj=OBJ, gnm=GNM):
    """The memetic block as host-scalar steps and refine_elites."""
    smax, smin = _dicts(sig_max, sig_min)
    E, ms = max(1, cfg.elite_k), []
    for _ in range(n):
        st, m = ga.step(st, obj, TGT, WM, cfg, gnm, smax, smin)
        if st.gen % refine_every == 0:
            st = ga._refine(st, _refine_elites(obj, gnm), E, TGT, WM)
        ms.append(torch.stack([st.best_fit, m[1], m[2], st.no_improve.to(m.dtype)]))
    return st, torch.stack(ms)


@pytest.mark.parametrize("sigmas", list(SIGMAS))
@pytest.mark.parametrize("refine_every", [3, 4])
def test_memetic_run_block_equals_step_and_refine_loop(refine_every, sigmas):
    """refine_every 3 refines inside blocks (3, 6, 9), 4 on the last
    generation of the first two (4, 8); the refinements change the run (it
    differs from the plain GA's), and run_memetic_block, the block once
    eagerly, equals it too."""
    cfg = _ga_cfg()
    sig_max, sig_min = SIGMAS[sigmas]
    st0 = ga.init(_rng(3), OBJ, TGT, WM, cfg, GNM)
    a, ma = _memetic_loop(st0._replace(rng=_rng()), cfg, refine_every, sum(BLOCKS), sig_max,
                          sig_min)
    run = ga.make_memetic_run_block(OBJ, cfg, GNM, GRAD, refine_every, REFINE_STEPS, sig_max,
                                    sig_min)
    b, mb = _blocks(run, st0._replace(rng=_rng()))
    assert _same(a, b) and b.gen == sum(BLOCKS)
    assert torch.equal(ma, mb)
    plain, _ = _blocks(ga.make_run_block(OBJ, cfg, GNM, sig_max, sig_min),
                       st0._replace(rng=_rng()))
    assert not torch.equal(plain.pop, b.pop)
    c, mc = ga.run_memetic_block(st0._replace(rng=_rng()), OBJ, TGT, WM, cfg, GNM, GRAD,
                                 refine_every, REFINE_STEPS, sum(BLOCKS), sig_max, sig_min)
    assert _same(a, c) and torch.equal(ma, mc)


def _island_loop(st, cfg, n_islands, migrate_every, n, sig_max=None, sig_min=None, blur=None):
    smax, smin = _dicts(sig_max, sig_min)
    ms = []
    for _ in range(n):
        st, m = island.step(st, OBJ, TGT, WM, cfg, GNM, smax, smin, n_islands, migrate_every, 1,
                            blur_sigma=blur)
        ms.append(m)
    return st, torch.stack(ms)


@pytest.mark.parametrize("migrate_every", [3, 4])
def test_island_run_block_equals_step_loop(migrate_every):
    """Two demes of 4: migrate_every 3 migrates inside blocks, 4 on the last
    generation of the first two."""
    cfg = _ga_cfg(pop_size=8)
    st0 = ga.init(_rng(3), OBJ, TGT, WM, cfg, GNM)
    a, ma = _island_loop(st0._replace(rng=_rng()), cfg, 2, migrate_every, sum(BLOCKS))
    run = island.make_run_block(OBJ, cfg, GNM, 2, migrate_every, 1)
    b, mb = _blocks(run, st0._replace(rng=_rng()))
    assert _same(a, b) and torch.equal(ma, mb)


@pytest.mark.parametrize("annealed", [False, True])
def test_island_step_rows_equal_scalar_form(annealed):
    """island.step reading its sigma row on the device equals its host-scalar
    form in bits over three blocks (the counter filled from state.gen at each
    block's start), at other sigmas, annealed at a 0-d blur sigma too; 11
    generations run past generations=9, where the table is rebuilt longer."""
    cfg = _ga_cfg(pop_size=8)
    blur = torch.tensor(1.5) if annealed else None
    smax, smin = _dicts(OTHER_MAX, OTHER_MIN)
    st0 = ga.init(_rng(3), OBJ, TGT, WM, cfg, GNM)
    a, b = st0._replace(rng=_rng()), st0._replace(rng=_rng())
    rows = ga._sigma_rows(cfg, smax, smin, "cpu")
    for n in BLOCKS:
        rows.cover(b.gen + n)
        rows.start(b.gen)
        for _ in range(n):
            a, ma = island.step(a, OBJ, TGT, WM, cfg, GNM, smax, smin, 2, 3, 1, blur_sigma=blur)
            b, mb = island.step(b, OBJ, TGT, WM, cfg, GNM, {}, {}, 2, 3, 1, blur_sigma=blur,
                                rows=rows)
            assert torch.equal(ma, mb)
        assert _same(a, b)


@pytest.mark.parametrize("metric,precision", [("mse", "exact-tight"), ("mix", "exact-tight"),
                                              ("mse", "fast")])
def test_make_refine_fresh_and_reused_equals_refine_elites(metric, precision, monkeypatch):
    """The helper's first call (a fresh Adam), a call on other elites and a
    third back on the first elites (moments and step reset in place) each
    equal refine_elites in bits; the helper builds one Adam for them all."""
    obj = OBJ._replace(metric=metric, precision=precision)
    first = torch.from_numpy(axes_genomes(61, 3, GNM.n_splats, H, W))
    other = torch.from_numpy(axes_genomes(62, 3, GNM.n_splats, H, W))
    adams = []
    monkeypatch.setattr(gradient, "make_adam", lambda g, cfg: adams.append(g) or
                        torch.optim.Adam([g], lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8))
    refine = gradient.make_refine(obj, GNM, GRAD, REFINE_STEPS)
    for el in (first, other, first):
        fits = objective.evaluate(obj, el, TGT, WM, device="cpu")
        got = refine(el, fits, TGT, WM)
        n_adams = len(adams)
        want = gradient.refine_elites(el, fits, TGT, WM, obj, GNM, GRAD, REFINE_STEPS)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool((got[1] < fits).any())  # the refinement improved an elite
        adams = adams[:n_adams]  # refine_elites' own
    assert len(adams) == 1


@pytest.mark.parametrize("metric", ["mse", "mix"])
def test_refine_matches_jax_refine_elites(metric):
    """The port's refinement (a helper used once on other elites first)
    against JAX's refine_elites under jax.jit on the same elites, target and
    mask: one elite's fit is given as 0, which no refinement beats, so the
    accept decisions hold both outcomes."""
    Hc, Wc, N, E, steps = 32, 48, 8, 3, 3
    g0 = axes_genomes(71, E, N, Hc, Wc)
    tgt, wm = image(72, Hc, Wc), weights(73, Hc, Wc)
    jobj = jobjective.Objective(H=Hc, W=Wc, impl="xla", precision="exact-tight", metric=metric)
    fits0 = np.array(jobjective.evaluate(jobj, jnp.asarray(g0), jnp.asarray(tgt),
                                         jnp.asarray(wm)), np.float32)
    fits0[1] = 0.0
    jgnm = JGenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
    jref = jax.jit(lambda el, ef, t, w: jgradient.refine_elites(
        el, ef, t, w, jobj, jgnm, JGradConfig(lr=1e-2), steps))
    gj, fj = (np.asarray(x) for x in jref(jnp.asarray(g0), jnp.asarray(fits0), jnp.asarray(tgt),
                                          jnp.asarray(wm)))
    tobj = objective.Objective(H=Hc, W=Wc, precision="exact-tight", metric=metric)
    refine = gradient.make_refine(tobj, GenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3),
                                  GradConfig(lr=1e-2), steps)
    tt, tw = torch.from_numpy(tgt), torch.from_numpy(wm)
    other = torch.from_numpy(axes_genomes(74, E, N, Hc, Wc))
    refine(other, objective.evaluate(tobj, other, tt, tw, device="cpu"), tt, tw)
    gt, ft = (x.numpy() for x in refine(torch.from_numpy(g0), torch.from_numpy(fits0), tt, tw))
    accepted = ft != fits0
    np.testing.assert_array_equal(accepted, fj != fits0)
    assert accepted.any() and not accepted.all()
    np.testing.assert_allclose(ft, fj, rtol=1e-5)
    np.testing.assert_allclose(gt[..., :5], gj[..., :5], atol=1e-5, rtol=0)
    np.testing.assert_allclose(gt[..., 5:], gj[..., 5:], atol=2e-5, rtol=0)


@pytest.mark.parametrize("mode", ["plain", "memetic", "islands"])
def test_genetic_approx_passes_sigmas_to_every_block(mode, monkeypatch):
    """genetic_approx(sig_max=, sig_min=) at other sigmas: the first
    generation's offspring are mutated at build_mut_sigma(1, ...) of them
    (a device row in SIG_COLS order), and the returned best and population
    equal host-scalar steps with them from the same seed in bits."""
    gens, seed = 5, 7
    cfg = _ga_cfg(pop_size=8, generations=gens)
    kw = {"memetic": {"memetic_every": 2, "memetic_steps": REFINE_STEPS, "memetic_lr": GRAD.lr},
          "islands": {"n_islands": 2, "migrate_every": 2, "migrate_k": 1}}.get(mode, {})
    seen = []
    plain = operators.apply_mutation

    def recorded(pop, draws, sig, *args):
        seen.append(sig)
        return plain(pop, draws, sig, *args)

    monkeypatch.setattr(operators, "apply_mutation", recorded)
    best, best_fit, _, pop = ga.genetic_approx(
        TGT, H, W, obj=OBJ, ga=cfg, gnm=GNM, sig_max=OTHER_MAX, sig_min=OTHER_MIN, seed=seed,
        log_every=3, weight_mask=WM, device="cpu", return_state=True, **kw)
    want = genome.build_mut_sigma(1, gens, cfg.schedule, OTHER_MAX.__dict__, OTHER_MIN.__dict__)
    row = torch.tensor([[want[c] for c in genome.SIG_COLS]], dtype=torch.float32)
    assert torch.equal(seen[0], row)

    st = ga.init(_rng(seed), OBJ, TGT, WM, cfg, GNM)
    if mode == "plain":
        smax, smin = _dicts(OTHER_MAX, OTHER_MIN)
        for _ in range(gens):
            st, _ = ga.step(st, OBJ, TGT, WM, cfg, GNM, smax, smin)
    elif mode == "memetic":
        st, _ = _memetic_loop(st, cfg, 2, gens, OTHER_MAX, OTHER_MIN)
    else:
        st, _ = _island_loop(st, cfg, 2, 2, gens, OTHER_MAX, OTHER_MIN)
    assert torch.equal(torch.from_numpy(best), st.best) and best_fit == float(st.best_fit)
    assert torch.equal(torch.from_numpy(pop), st.pop)
