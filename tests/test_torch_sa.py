"""Port SA and PT (ggs_tpu_torch/models/sa.py, pt.py) against
ggs_tpu/models/sa.py and pt.py on replayed draws, on the CPU.

jax.random streams cannot be reproduced by torch generators, so these tests
rebuild the JAX step's random numbers from its key splits and hand them to
the port's step as `draws`:
* batched SA: split(key, 3) -> (key, k_prop, k_acc); split(k_prop, tries)
  and mutate_individual's split(key, 14); per acceptance split(k) -> (k, k_u)
  and uniform(k_u);
* sequential SA: split(k_prop, tries), each split into (k_m, k_u);
* PT: split(key, 4) -> (key, k_prop, k_acc, k_swap); split(k_prop, K * tries)
  .reshape(tries, K, 2) (row t * K + k mutates replica k); per try
  uniform(k_u, (K,)); uniform(k_swap, (K,)).
Each part is held on its own, on the same inputs in both packages (the
proposals mutate the port's state): proposals within atol 1e-6, energies within
rtol 5e-5 (tests/test_render_pallas.py:140), temp_schedule and temp_ladder
within 1 ulp, and the acceptance chain and swap sweep, given the same
energies in both packages (objective.evaluate replaced in each), with equal
decisions and states. Then whole iterations end to end on the real
energies. A decision flips when u lies within the energies' tolerance of
its threshold, so these tests first replay each decision on JAX's energies
moved by that tolerance both ways and assert it stays the same: no case
here depends on a lucky seed. The JAX side scores with impl="xla". Its
proposals come from mutate_individual run eagerly, as tests/test_torch_ga.py
runs it; JAX's compiled steps (its run blocks) round the same mutation a
few ulps apart from its eager one (up to 7.6e-6 on a 0-255 colour, 5e-7
relative, with equal sigmas and draws), so whole steps hold genomes to
rtol 2e-6 besides atol 1e-6. The port's own draws are held to the
invariants tests/test_sa.py and tests/test_pt.py pin."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.config import GenomeConfig as JGenomeConfig
from ggs_tpu.config import SAConfig as JSAConfig
from ggs_tpu.models import genome as jgenome
from ggs_tpu.models import operators as jops
from ggs_tpu.models import pt as jpt
from ggs_tpu.models import sa as jsa
from ggs_tpu.ops import objective as jobjective
from ggs_tpu_torch import convert
from ggs_tpu_torch.config import GenomeConfig, MutSigma, SAConfig
from ggs_tpu_torch.models import genome as tgenome
from ggs_tpu_torch.models import operators as tops
from ggs_tpu_torch.models import pt as tpt
from ggs_tpu_torch.models import sa as tsa
from ggs_tpu_torch.ops import objective as tobjective
from test_torch_ga import jax_mutation_draws, jax_mutation_draws_from_keys
from torch_inputs import image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, N = 32, 160, 16
TRIES, K = 4, 3
ENERGY_RTOL = 5e-5
JIT_RTOL = 2e-6  # JAX's compiled step against its eager mutate (see above)
SIG_MAX = MutSigma.max_defaults().__dict__
SIG_MIN = MutSigma.min_defaults().__dict__
JGNM = JGenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
TGNM = GenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
JOBJ = jobjective.Objective(H=H, W=W, impl="xla", precision="exact-tight")
TOBJ = tobjective.Objective(H=H, W=W, precision="exact-tight")
KINDS = ["exp", "linear", "cosine", "log", "cauchy"]


def _cfgs(**kw):
    return JSAConfig(**kw), SAConfig(**kw)


def _inputs(seed):
    tgt, wm = image(seed, H, W), weights(seed + 1, H, W)
    return (jnp.asarray(tgt), jnp.asarray(wm)), (torch.from_numpy(tgt), torch.from_numpy(wm))


def _leaves(state):
    return [np.array(x) for x in jax.tree.flatten(state)[0]]


def _u(keys, shape=()):
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys]))


def _chain_keys(k_acc, tries):
    """acc_body's k_u for each try: k, k_u = split(k)."""
    out, k = [], k_acc
    for _ in range(tries):
        k, k_u = jax.random.split(k)
        out.append(k_u)
    return out


def jax_sa_draws(key, tries, mode):
    _, k_prop, k_acc = jax.random.split(key, 3)
    if mode == "batched":
        return {"mut": jax_mutation_draws(k_prop, tries, N), "u_acc": _u(_chain_keys(k_acc, tries))}
    pairs = [jax.random.split(k) for k in jax.random.split(k_prop, tries)]
    return {"mut": jax_mutation_draws_from_keys([p[0] for p in pairs], N),
            "u_acc": _u([p[1] for p in pairs])}


def jax_pt_draws(key, tries, K):
    _, k_prop, k_acc, k_swap = jax.random.split(key, 4)
    return {"mut": jax_mutation_draws(k_prop, tries * K, N),
            "u_acc": _u(_chain_keys(k_acc, tries), (K,)),
            "u_swap": torch.from_numpy(np.asarray(jax.random.uniform(k_swap, (K,))))}


def _same_sigmas(it, cfg):
    """The port's annealed sigmas, asserted equal to JAX's: the whole steps
    hold genomes to atol 1e-6, which an ulp of a 0-255 colour sigma would
    exceed (build_mut_sigma's own gap is tests/test_torch_ga.py's)."""
    got = tgenome.build_mut_sigma(it, cfg.iterations, cfg.sigma_schedule, SIG_MAX, SIG_MIN)
    want = jgenome.build_mut_sigma(jnp.int32(it), cfg.iterations, cfg.sigma_schedule, SIG_MAX,
                                   SIG_MIN)
    assert got == {k: float(v) for k, v in want.items()}, f"sigmas differ at iteration {it}"
    return got


def _jax_sigmas(it, cfg):
    return jgenome.build_mut_sigma(it, cfg.iterations, cfg.sigma_schedule, SIG_MAX, SIG_MIN)


def _accepts(dE, u, T):
    return dE <= 0.0 or u < np.exp(-dE / max(T, 1e-30))


def _clear_decision(e_new, e_cur, u, T, what):
    """The Metropolis decision on float64 copies of JAX's energies, asserted
    to stay the same when both energies move by the cross-package tolerance."""
    tol = 2 * ENERGY_RTOL * max(abs(e_new), abs(e_cur)) + 1e-12
    lo, hi = _accepts(e_new - e_cur - tol, u, T), _accepts(e_new - e_cur + tol, u, T)
    assert lo == hi, f"{what}: u={u} lies within the energy tolerance of its threshold"
    return lo


@pytest.mark.parametrize("kind", KINDS)
def test_temp_schedule_matches_jax(kind):
    for total in (1, 7, 100, 500_000):
        its = sorted({0, 1, 2, total // 3, total // 2, total - 1, total, total + 5})
        got = np.array([tgenome.temp_schedule(kind, 1e-3, i, total) for i in its], np.float32)
        want = np.array([jgenome.temp_schedule(kind, 1e-3, jnp.int32(i), total) for i in its],
                        np.float32)
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert tgenome.temp_schedule("unknown", 1e-3, 5, 9) == tgenome.temp_schedule("exp", 1e-3, 5, 9)


def test_temp_ladder_matches_jax():
    for t_cold, t_hot, k in ((1e-3, 1e-1, 5), (1e-3, 0.1, 4), (2e-4, 3e-2, 8), (1e-3, 1.0, 1)):
        got = tpt.temp_ladder(t_cold, t_hot, k).numpy()
        np.testing.assert_array_max_ulp(got, np.asarray(jpt.temp_ladder(t_cold, t_hot, k)), maxulp=1)
    t = tpt.temp_ladder(1e-3, 1e-1, 5).numpy()
    assert t[0] == np.float32(1e-3)
    np.testing.assert_allclose(t[-1], 1e-1, rtol=1e-5)
    np.testing.assert_allclose(t[1:] / t[:-1], t[1] / t[0], rtol=1e-5)


def _jax_mutate(keys, inds, sig, mutpb, scales=None):
    """JAX's mutate_individual, run eagerly, for each (key, individual);
    with `scales`, individual i's sigmas times scales[i] (pt.py:116-122)."""
    out = []
    for i, (k, ind) in enumerate(zip(keys, inds)):
        s = sig if scales is None else {n: v * scales[i] for n, v in sig.items()}
        out.append(np.asarray(jops.mutate_individual(k, ind, s, mutpb, H, W, JGNM.min_scale,
                                                     JGNM.max_scale)))
    return np.stack(out)


_JEVAL = jax.jit(lambda g, t, w: jobjective.evaluate(JOBJ, g, t, w))


def _close_genomes(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=JIT_RTOL, atol=1e-6)


def test_sa_batched_steps_match_jax():
    """Three batched iterations, each part by part (the tries proposals,
    their energies, the decisions) and then whole against JAX's run block."""
    (jt, jw), (tt, tw) = _inputs(7)
    jcfg, tcfg = _cfgs(iterations=20, tries_per_iter=TRIES, t0=1e-2, mutpb=0.2)
    js = jsa.init(jax.random.PRNGKey(3), JOBJ, jt, jw, JGNM)
    ts = convert.sa_state_from_jax(_leaves(js), device="cpu")
    np.testing.assert_allclose(
        tobjective.evaluate(TOBJ, ts.curr[None], tt, tw, device="cpu").numpy(),
        [float(js.curr_fit)], rtol=ENERGY_RTOL)
    jrun = jsa.make_run_block(JOBJ, jcfg, JGNM)
    decisions = []
    for _ in range(3):
        draws = jax_sa_draws(js.key, TRIES, "batched")
        sig = _same_sigmas(ts.it, tcfg)
        keys = jax.random.split(jax.random.split(js.key, 3)[1], TRIES)
        props_j = _jax_mutate(keys, [jnp.asarray(ts.curr.numpy())] * TRIES,
                              _jax_sigmas(js.it, jcfg), jcfg.mutpb)
        props_t = tops.apply_mutation(ts.curr[None].expand(TRIES, N, 9), draws["mut"], sig,
                                      tcfg.mutpb, H, W, TGNM.min_scale, TGNM.max_scale)
        np.testing.assert_allclose(props_t.numpy(), props_j, atol=1e-6)
        e_j = np.asarray(_JEVAL(props_j, jt, jw), np.float64)
        e_t = tobjective.evaluate(TOBJ, props_t, tt, tw, device="cpu").numpy()
        np.testing.assert_allclose(e_t, e_j, rtol=ENERGY_RTOL)
        T = float(jgenome.temp_schedule(jcfg.temp_schedule, jcfg.t0, js.it, jcfg.iterations))
        cur = e0 = float(js.curr_fit)
        for t in range(TRIES):
            acc = _clear_decision(e_j[t], cur, float(draws["u_acc"][t]), T, f"it {ts.it} try {t}")
            cur = e_j[t] if acc else cur
            decisions.append((acc, e_j[t] > e0))

        js, jm = jrun(js, jt, jw, 1)
        ts, tm = tsa.step(ts, TOBJ, tt, tw, tcfg, TGNM, SIG_MAX, SIG_MIN, draws=draws)
        _close_genomes(ts.curr, js.curr)
        _close_genomes(ts.best, js.best)
        np.testing.assert_allclose(float(ts.curr_fit), cur, rtol=ENERGY_RTOL)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm[0]), rtol=ENERGY_RTOL)
        assert ts.it == int(js.it)
    # both outcomes of an uphill proposal occur
    assert {a for a, up in decisions if up} == {True, False}


def test_sa_sequential_steps_match_jax():
    """Two sequential iterations: the chain replayed on JAX's pieces (its
    mutate, evaluate and decisions), against the port's step; then JAX's
    run block."""
    (jt, jw), (tt, tw) = _inputs(8)
    jcfg, tcfg = _cfgs(iterations=20, tries_per_iter=TRIES, t0=2e-3, mutpb=0.2,
                       proposal_mode="sequential")
    js = jsa.init(jax.random.PRNGKey(4), JOBJ, jt, jw, JGNM)
    ts = convert.sa_state_from_jax(_leaves(js), device="cpu")
    jrun = jsa.make_run_block(JOBJ, jcfg, JGNM)
    for _ in range(2):
        draws = jax_sa_draws(js.key, TRIES, "sequential")
        _same_sigmas(ts.it, tcfg)
        T = float(jgenome.temp_schedule(jcfg.temp_schedule, jcfg.t0, js.it, jcfg.iterations))
        sig = _jax_sigmas(js.it, jcfg)
        k_prop = jax.random.split(js.key, 3)[1]
        curr, cur = jnp.asarray(ts.curr.numpy()), float(js.curr_fit)
        for t, k in enumerate(jax.random.split(k_prop, TRIES)):
            prop = _jax_mutate([jax.random.split(k)[0]], [curr], sig, jcfg.mutpb)
            e = float(_JEVAL(prop, jt, jw)[0])
            if _clear_decision(e, cur, float(draws["u_acc"][t]), T, f"it {ts.it} try {t}"):
                curr, cur = jnp.asarray(prop[0]), e
        ts, tm = tsa.step(ts, TOBJ, tt, tw, tcfg, TGNM, SIG_MAX, SIG_MIN, draws=draws)
        np.testing.assert_allclose(ts.curr.numpy(), np.asarray(curr), atol=1e-6)
        np.testing.assert_allclose(float(ts.curr_fit), cur, rtol=ENERGY_RTOL)
        js, jm = jrun(js, jt, jw, 1)
        _close_genomes(ts.curr, js.curr)
        _close_genomes(ts.best, js.best)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm[0]), rtol=ENERGY_RTOL)


def _fixed_energies(monkeypatch, energies):
    """objective.evaluate in both packages returns the next row of
    `energies`: JAX's through a host callback, which its compiled step
    calls once per iteration, the port's the same row after it."""
    rows = iter(energies)
    current = {}

    def row():
        current["row"] = next(rows)
        return current["row"]

    def jfake(obj, g, target, weight_mask=None):
        return jax.pure_callback(row, jax.ShapeDtypeStruct((g.shape[0],), jnp.float32))

    def tfake(obj, g, target, weight_mask=None, device="cuda"):
        return torch.from_numpy(current["row"])

    monkeypatch.setattr(jobjective, "evaluate", jfake)
    monkeypatch.setattr(tobjective, "evaluate", tfake)


def test_sa_acceptance_chain_on_identical_energies(monkeypatch):
    (jt, jw), (tt, tw) = _inputs(9)
    jcfg, tcfg = _cfgs(iterations=10, tries_per_iter=TRIES, t0=1e-2)
    js = jsa.init(jax.random.PRNGKey(5), JOBJ, jt, jw, JGNM)
    ts = convert.sa_state_from_jax(_leaves(js), device="cpu")
    rng = np.random.default_rng(0)
    e0 = float(js.curr_fit)
    energies = [(e0 + 1e-2 * rng.standard_normal(TRIES)).astype(np.float32) for _ in range(3)]
    _fixed_energies(monkeypatch, energies)
    jrun = jsa.make_run_block(JOBJ, jcfg, JGNM)
    for i in range(3):
        draws = jax_sa_draws(js.key, TRIES, "batched")
        _same_sigmas(ts.it, tcfg)
        T = float(jgenome.temp_schedule(jcfg.temp_schedule, jcfg.t0, js.it, jcfg.iterations))
        cur = float(js.curr_fit)
        for t in range(TRIES):
            dE = float(energies[i][t]) - cur
            u = float(draws["u_acc"][t])
            assert dE <= 0.0 or abs(u - np.exp(-dE / T)) > 1e-5, "u within ulps of its threshold"
            cur = float(energies[i][t]) if _accepts(dE, u, T) else cur
        js, jm = jrun(js, jt, jw, 1)
        ts, tm = tsa.step(ts, TOBJ, tt, tw, tcfg, TGNM, SIG_MAX, SIG_MIN, draws=draws)
        assert float(ts.curr_fit) == float(js.curr_fit) == np.float32(cur)
        assert float(ts.best_fit) == float(js.best_fit)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm[0]))
        _close_genomes(ts.curr, js.curr)
        _close_genomes(ts.best, js.best)


def _pt_pair(seed, jcfg):
    (jt, jw), (tt, tw) = _inputs(seed)
    js = jpt.init(jax.random.PRNGKey(seed), JOBJ, jt, jw, JGNM, K, jcfg.t0, 30 * jcfg.t0)
    ts = convert.pt_state_from_jax(_leaves(js), device="cpu")
    return (jt, jw), (tt, tw), js, ts


def test_pt_chain_and_swaps_on_identical_energies(monkeypatch):
    """PT's per-replica chains and the swap sweep (both parities) on the
    same energies in both packages: equal fits and decisions, genomes
    within the proposals' tolerance."""
    jcfg, tcfg = _cfgs(iterations=10, tries_per_iter=TRIES, t0=1e-2)
    (jt, jw), (tt, tw), js, ts = _pt_pair(10, jcfg)
    rng = np.random.default_rng(1)
    e0 = float(js.fits.mean())
    energies = [(e0 + 2e-2 * rng.standard_normal(TRIES * K)).astype(np.float32) for _ in range(3)]
    _fixed_energies(monkeypatch, energies)
    jrun = jpt.make_run_block(JOBJ, jcfg, JGNM, swap_every=1)
    for i in range(3):
        draws = jax_pt_draws(js.key, TRIES, K)
        _same_sigmas(ts.it, tcfg)
        js, jm = jrun(js, jt, jw, 1)
        ts, tm = tpt.step(ts, TOBJ, tt, tw, tcfg, TGNM, SIG_MAX, SIG_MIN, 1, draws=draws)
        np.testing.assert_array_equal(ts.fits.numpy(), np.asarray(js.fits))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm[0]))
        _close_genomes(ts.reps, js.reps)
        _close_genomes(ts.best, js.best)
    assert ts.it == 3


def test_pt_steps_match_jax():
    """Three PT iterations end to end on the real energies (a swap sweep
    every iteration, both parities): proposals, energies, chains, swaps."""
    jcfg, tcfg = _cfgs(iterations=30, tries_per_iter=TRIES, t0=2e-3, mutpb=0.2)
    (jt, jw), (tt, tw), js, ts = _pt_pair(11, jcfg)
    np.testing.assert_array_equal(ts.temps.numpy(), np.asarray(js.temps))
    jrun = jpt.make_run_block(JOBJ, jcfg, JGNM, swap_every=1)
    for _ in range(3):
        draws = jax_pt_draws(js.key, TRIES, K)
        sig = _same_sigmas(ts.it, tcfg)
        keys = jax.random.split(jax.random.split(js.key, 4)[1], K * TRIES)
        scale_j = jnp.sqrt(js.temps / js.temps[0])
        reps = jnp.asarray(ts.reps.numpy())
        props_j = _jax_mutate(keys, [reps[p % K] for p in range(K * TRIES)],
                              _jax_sigmas(js.it, jcfg), jcfg.mutpb,
                              [scale_j[p % K] for p in range(K * TRIES)])
        scale = torch.sqrt(ts.temps / ts.temps[0]).repeat(TRIES)
        props_t = tops.apply_mutation(
            ts.reps.repeat(TRIES, 1, 1), draws["mut"], {n: scale * v for n, v in sig.items()},
            tcfg.mutpb, H, W, TGNM.min_scale, TGNM.max_scale)
        np.testing.assert_allclose(props_t.numpy(), props_j, atol=1e-6)
        e_j = np.asarray(_JEVAL(props_j, jt, jw), np.float64)
        e_t = tobjective.evaluate(TOBJ, props_t, tt, tw, device="cpu").numpy()
        np.testing.assert_allclose(e_t, e_j, rtol=ENERGY_RTOL)

        # each decision on JAX's energies, clear of the tolerance band
        t_base = jgenome.temp_schedule(jcfg.temp_schedule, jcfg.t0, js.it, jcfg.iterations)
        temps = np.asarray(js.temps * (t_base / jnp.float32(jcfg.t0)), np.float64)
        fits = np.asarray(js.fits, np.float64)
        e_j = e_j.reshape(TRIES, K)
        for t in range(TRIES):
            for k in range(K):
                if _clear_decision(e_j[t, k], fits[k], float(draws["u_acc"][t, k]), temps[k],
                                   f"it {ts.it} try {t} replica {k}"):
                    fits[k] = e_j[t, k]
        beta, u = 1.0 / temps, draws["u_swap"].numpy()
        for i in range(ts.it % 2, K - 1, 2):
            tol = 2 * ENERGY_RTOL * np.abs(fits[[i, i + 1]]).max() * 2 * abs(beta[i] - beta[i + 1])
            arg = (beta[i] - beta[i + 1]) * (fits[i] - fits[i + 1])
            lo, hi = (u[i] < np.exp(min(a, 0.0)) for a in (arg - tol, arg + tol))
            assert lo == hi, f"it {ts.it}: swap ({i}, {i + 1}) within the energy tolerance"

        js, jm = jrun(js, jt, jw, 1)
        ts, tm = tpt.step(ts, TOBJ, tt, tw, tcfg, TGNM, SIG_MAX, SIG_MIN, 1, draws=draws)
        _close_genomes(ts.reps, js.reps)
        _close_genomes(ts.best, js.best)
        np.testing.assert_allclose(ts.fits.numpy(), np.asarray(js.fits), rtol=ENERGY_RTOL)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm[0]), rtol=ENERGY_RTOL)


# --- invariants on the port's own draws (tests/test_sa.py, tests/test_pt.py)

def test_metropolis_invariants():
    gen = torch.Generator().manual_seed(0)
    curr, prop = torch.zeros((2, 9)), torch.ones((2, 9))
    c, f, acc = tsa._metropolis(torch.rand((), generator=gen), curr, torch.tensor(1.0), prop,
                                torch.tensor(0.5), tsa.temperature(1e-9, "cpu"))
    assert bool(acc) and float(f) == 0.5 and bool((c == 1.0).all())
    cold, hot = tsa.temperature(1e-12, "cpu"), tsa.temperature(10.0, "cpu")
    u = torch.rand((50,), generator=gen)
    up = [tsa._metropolis(u[i], curr, torch.tensor(0.5), prop, torch.tensor(1.0), cold)[2]
          for i in range(20)]
    assert not any(bool(a) for a in up)
    warm = [tsa._metropolis(u[i], curr, torch.tensor(0.5), prop, torch.tensor(0.5001), hot)[2]
            for i in range(50)]
    assert sum(bool(a) for a in warm) >= 45


@pytest.mark.parametrize("mode", ["batched", "sequential", "pt"])
def test_run_blocks_keep_best_monotone(mode):
    _, (tt, _) = _inputs(12)
    cfg = SAConfig(iterations=40, tries_per_iter=TRIES, t0=1e-3,
                   proposal_mode="sequential" if mode == "sequential" else "batched")
    gen = torch.Generator().manual_seed(2)
    if mode == "pt":
        st = tpt.init(gen, TOBJ, tt, None, TGNM, K, 1e-3, 1e-1)
        run = tpt.make_run_block(TOBJ, cfg, TGNM, swap_every=2)
    else:
        st = tsa.init(gen, TOBJ, tt, None, TGNM)
        run = tsa.make_run_block(TOBJ, cfg, TGNM)
    b0 = float(st.best_fit)
    st, m = run(st, tt, None, 12)
    m = m.numpy()
    assert m.shape == (12, 2) and np.isfinite(m).all()
    assert np.all(np.diff(m[:, 0]) <= 0.0) and m[0, 0] <= b0 and m[-1, 0] < b0
    assert np.all(m[:, 0] <= m[:, 1] + 1e-7)
    if mode == "pt":  # swaps carry each genome's energy with it
        refit = tobjective.evaluate(TOBJ, st.reps, tt, None, device="cpu")
        np.testing.assert_allclose(refit.numpy(), st.fits.numpy(), rtol=1e-6)


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_preserves_multiset(parity):
    gen = torch.Generator().manual_seed(3 + parity)
    K5 = 5
    reps = torch.rand((K5, 4, 9), generator=gen)
    fits = torch.rand((K5,), generator=gen)
    temps = tpt.temp_ladder(1e-3, 1e-1, K5) * 50.0
    moved = 0
    for _ in range(10):
        u = torch.rand((K5,), generator=gen)
        r2, f2 = tpt._swap(reps, fits, temps, u, parity)
        perm = [int(torch.nonzero((reps == r).all(dim=(1, 2)))[0]) for r in r2]
        assert sorted(perm) == list(range(K5))
        np.testing.assert_array_equal(f2.numpy(), fits.numpy()[perm])
        for i, p in enumerate(perm):  # only neighbours of the sweep's parity trade
            assert p == i or (abs(p - i) == 1 and min(p, i) % 2 == parity)
        moved += sum(p != i for i, p in enumerate(perm))
    assert moved > 0


def test_simulated_annealing_driver(tmp_path):
    tgt = image(13, H, W)
    cfg = SAConfig(iterations=8, tries_per_iter=2)
    for replicas in (1, 3):
        best, best_fit, curves = tsa.simulated_annealing(
            tgt, H, W, obj=TOBJ, sa=cfg, gnm=TGNM, seed=0, log_every=4,
            loss_csv_path=str(tmp_path / f"sa_{replicas}.csv"), replicas=replicas,
            swap_every=2, device="cpu",
        )
        assert best.shape == (N, 9) and np.isfinite(best_fit)
        assert len(curves["best"]) == len(curves["current"]) == 9
        assert best_fit == pytest.approx(curves["best"][-1], rel=1e-6)
        assert (tmp_path / f"sa_{replicas}.csv").exists()
