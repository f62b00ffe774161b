"""The port's run blocks (make_run_block of models/ga.py, gradient.py, sa.py
and pt.py; utils/block_graph.py), on the CPU at a small size (24x24, N=6),
where every kernel wrapper takes its plain version and a block runs its
eager body.

* The per-step tables a run uploads once (genome.mut_sigma_table,
  genome.temp_table, sa.step_table) equal the host's per-step values
  (build_mut_sigma, temp_schedule) in bits for every step of each schedule
  kind, past the schedule's end too, and JAX's build_mut_sigma and
  temp_schedule evaluated under jax.jit at a traced step within rtol 2e-6
  (tests/test_torch_sa.py's JIT_RTOL, for JAX's compiled steps), the
  temperatures also within atol 2e-6 x t0: XLA lowers the jitted i / total
  as a product with the reciprocal, which moves a temperature near the
  end of the linear and cosine schedules by up to 1048 ulp (6e-8 x t0 at
  total 1000), where the port's host values, like JAX's eager ones,
  divide (test_torch_sa.py holds those to 1 ulp).
* A step reading its row on the device (ga.step, sa.step in both modes,
  pt.step with swaps inside a block and on a block boundary) equals the
  host-scalar step in bits, over three blocks with a shorter last one.
* Each make_run_block equals the old eager loop of host-scalar steps in
  bits (state, metrics and the generator's state); the Adam block equals
  its step loop.
* The Adam a card runs (torch.optim's fused update, capturable there)
  stays within tests/test_torch_gradient.py's tolerance of optax's Adam;
  on the CPU its fused update runs, on a card (marked `cuda`, skipped
  here) its capturable one is held to the CPU's.
* A replay's launch counts: what a capture advanced is set back and added
  once a replay (block_graph's counters and TALLIES)."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.config import GenomeConfig as JGenomeConfig
from ggs_tpu.config import GradConfig as JGradConfig
from ggs_tpu.models import genome as jgenome
from ggs_tpu.models import gradient as jgradient
from ggs_tpu.ops import objective as jobjective
from ggs_tpu_torch import convert
from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig, MutSigma, SAConfig
from ggs_tpu_torch.models import ga, genome, gradient, pt, sa
from ggs_tpu_torch.ops import objective
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.utils import block_graph
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H = W = 24
GNM = GenomeConfig(n_splats=6, min_scale=1.0, max_scale=0.3)
OBJ = objective.Objective(H=H, W=W, precision="exact-tight")
TGT = torch.from_numpy(image(21, H, W))
WM = torch.from_numpy(weights(22, H, W))
SIG_MAX = MutSigma.max_defaults().__dict__
SIG_MIN = MutSigma.min_defaults().__dict__
BLOCKS = (4, 4, 3)  # three blocks, the last shorter
TOTALS = (1, 7, 100, 1000)
GA_KINDS = ["cosine", "linear", "exp", "unknown"]
JIT_RTOL = 2e-6  # tests/test_torch_sa.py: JAX's compiled steps
TEMP_KINDS = ["exp", "linear", "cosine", "log", "cauchy", "unknown"]


def _rng(seed=5):
    return torch.Generator().manual_seed(seed)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", GA_KINDS)
def test_mut_sigma_table_rows_equal_build_mut_sigma(kind):
    for total in TOTALS:
        rows = total + 6  # past the schedule's end: the factor clamps there
        table = genome.mut_sigma_table(total, kind, SIG_MAX, SIG_MIN, rows)
        assert table.shape == (rows, 8) and table.dtype == np.float32
        want = np.array([[genome.build_mut_sigma(g, total, kind, SIG_MAX, SIG_MIN)[c]
                          for c in genome.SIG_COLS] for g in range(rows)], np.float32)
        np.testing.assert_array_equal(_bits(table), _bits(want))
    assert genome.mut_sigma_table(9, kind, SIG_MAX, SIG_MIN).shape == (10, 8)


@pytest.mark.parametrize("kind", TEMP_KINDS)
def test_temp_table_rows_equal_temp_schedule(kind):
    for total in TOTALS:
        rows = total + 6
        table = genome.temp_table(kind, 1e-3, total, rows)
        want = np.array([genome.temp_schedule(kind, 1e-3, i, total) for i in range(rows)],
                        np.float32)
        assert table.shape == (rows,) and table.dtype == np.float32
        np.testing.assert_array_equal(_bits(table), _bits(want))


@pytest.mark.parametrize("kind", GA_KINDS[:3])
def test_mut_sigma_table_matches_jax_jit(kind):
    for total in (7, 1000):
        gens = jnp.arange(total + 3, dtype=jnp.int32)
        jit = jax.jit(jax.vmap(lambda g: jgenome.build_mut_sigma(g, total, kind, SIG_MAX,
                                                                 SIG_MIN)))
        want = jit(gens)
        want = np.stack([np.asarray(want[c], np.float32) for c in genome.SIG_COLS], axis=1)
        got = genome.mut_sigma_table(total, kind, SIG_MAX, SIG_MIN, total + 3)
        np.testing.assert_allclose(got, want, rtol=JIT_RTOL, atol=0)


@pytest.mark.parametrize("kind", TEMP_KINDS[:5])
def test_temp_table_matches_jax_jit(kind):
    for total in (7, 1000):
        its = jnp.arange(total + 3, dtype=jnp.int32)
        want = jax.jit(jax.vmap(lambda i: jgenome.temp_schedule(kind, 1e-3, i, total)))(its)
        got = genome.temp_table(kind, 1e-3, total, total + 3)
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=JIT_RTOL,
                                   atol=JIT_RTOL * 1e-3)


def test_sa_step_table_columns():
    """sa.step_table: the sigmas, then the temperature or, with ratio, PT's
    ladder factor temperature / f32(t0) (pt.step's host division)."""
    cfg = SAConfig(iterations=50, t0=2e-3, temp_schedule="log", sigma_schedule="linear")
    tab = sa.step_table(cfg, SIG_MAX, SIG_MIN)
    ratio = sa.step_table(cfg, SIG_MAX, SIG_MIN, ratio=True)
    assert tab.shape == ratio.shape == (51, 9)
    for i in (0, 1, 25, 50):
        t = genome.temp_schedule("log", 2e-3, i, 50)
        assert tab[i, 8] == t and ratio[i, 8] == np.float32(t / np.float32(2e-3))
        sig = genome.build_mut_sigma(i, 50, "linear", SIG_MAX, SIG_MIN)
        assert list(tab[i, :8]) == [np.float32(sig[c]) for c in genome.SIG_COLS]


def test_step_rows_grow_past_the_table():
    """StepRows.cover rebuilds a longer table when a block reads past it
    (its version counts the rebuilds); the rows it had stay the same."""
    make = lambda r: genome.mut_sigma_table(5, "cosine", SIG_MAX, SIG_MIN, r)  # noqa: E731
    rows = genome.StepRows(make, 6, "cpu")
    old = rows.table.clone()
    rows.cover(5)
    assert rows.version == 0
    rows.cover(9)
    assert rows.version == 1 and rows.table.shape[0] >= 10
    assert torch.equal(rows.table[:6], old)
    rows.start(8)
    assert torch.equal(rows.row(), torch.from_numpy(make(9)[8:9]))
    rows.advance()
    assert int(rows.count) == 9


def _same(a, b, n_tensors):
    return all(torch.equal(x, y) for x, y in zip(a[:n_tensors], b[:n_tensors]))


def _ga_cfg():
    return GAConfig(pop_size=6, generations=9, elite_k=2, cxpb=0.5, mutpb=0.3)


@pytest.mark.parametrize("annealed", [False, True])
def test_ga_step_rows_equal_scalar_form(annealed):
    """ga.step reading its sigma row on the device equals its host-scalar
    form in bits, over three blocks (the counter filled from state.gen at
    each block's start), annealed at a 0-d blur sigma too; 11 generations
    run past generations=9, where the table is rebuilt longer."""
    cfg = _ga_cfg()
    blur = torch.tensor(1.5) if annealed else None
    st0 = ga.init(_rng(3), OBJ, TGT, WM, cfg, GNM)
    a, b = st0._replace(rng=_rng()), st0._replace(rng=_rng())
    rows = ga._sigma_rows(cfg, SIG_MAX, SIG_MIN, "cpu")
    for n in BLOCKS:
        rows.cover(b.gen + n)
        rows.start(b.gen)
        for _ in range(n):
            a, ma = ga.step(a, OBJ, TGT, WM, cfg, GNM, SIG_MAX, SIG_MIN, blur_sigma=blur)
            b, mb = ga.step(b, OBJ, TGT, WM, cfg, GNM, SIG_MAX, SIG_MIN, blur_sigma=blur,
                            rows=rows)
            assert torch.equal(ma, mb)
        assert _same(a, b, 5) and a.gen == b.gen
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_sa_step_rows_equal_scalar_form(mode):
    cfg = SAConfig(iterations=12, tries_per_iter=3, t0=1e-2, proposal_mode=mode,
                   temp_schedule="log", sigma_schedule="exp")
    st0 = sa.init(_rng(3), OBJ, TGT, WM, GNM)
    a, b = st0._replace(rng=_rng()), st0._replace(rng=_rng())
    rows = genome.StepRows(lambda r: sa.step_table(cfg, SIG_MAX, SIG_MIN, r), 13, "cpu")
    for n in BLOCKS:
        rows.start(b.it)
        for _ in range(n):
            a, ma = sa.step(a, OBJ, TGT, WM, cfg, GNM, SIG_MAX, SIG_MIN)
            b, mb = sa.step(b, OBJ, TGT, WM, cfg, GNM, SIG_MAX, SIG_MIN, rows=rows)
            assert torch.equal(ma, mb)
        assert _same(a, b, 4) and a.it == b.it
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.mark.parametrize("swap_every", [2, 4])
def test_pt_step_rows_equal_scalar_form(swap_every):
    """Blocks of 4, 4, 3: swap_every 2 swaps inside blocks, swap_every 4 on
    each block's last iteration, at both parities."""
    cfg = SAConfig(iterations=12, tries_per_iter=2, t0=1e-2)
    st0 = pt.init(_rng(3), OBJ, TGT, WM, GNM, 3, t_cold=1e-2, t_hot=1.0)
    a, b = st0._replace(rng=_rng()), st0._replace(rng=_rng())
    rows = genome.StepRows(lambda r: sa.step_table(cfg, SIG_MAX, SIG_MIN, r, ratio=True), 13,
                           "cpu")
    for n in BLOCKS:
        rows.start(b.it)
        for _ in range(n):
            a, ma = pt.step(a, OBJ, TGT, WM, cfg, GNM, SIG_MAX, SIG_MIN, swap_every)
            b, mb = pt.step(b, OBJ, TGT, WM, cfg, GNM, SIG_MAX, SIG_MIN, swap_every, rows=rows)
            assert torch.equal(ma, mb)
        assert _same(a, b, 5) and a.it == b.it
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def _blocks(run, state, *args, **kw):
    out = []
    for n in BLOCKS:
        state, m = run(state, TGT, WM, n, *args, **kw)
        out.append(m)
    return state, torch.cat(out)


@pytest.mark.parametrize("annealed", [False, True])
def test_ga_make_run_block_equals_eager_loop(annealed):
    cfg = _ga_cfg()
    blur = torch.tensor(2.0) if annealed else None
    st0 = ga.init(_rng(3), OBJ, TGT, WM, cfg, GNM)
    a, ms = st0._replace(rng=_rng()), []
    for _ in range(sum(BLOCKS)):
        a, m = ga.step(a, OBJ, TGT, WM, cfg, GNM, SIG_MAX, SIG_MIN, blur_sigma=blur)
        ms.append(m)
    b, mb = _blocks(ga.make_run_block(OBJ, cfg, GNM), st0._replace(rng=_rng()),
                    blur_sigma=blur)
    assert _same(a, b, 5) and a.gen == b.gen == sum(BLOCKS)
    assert torch.equal(torch.stack(ms), mb)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    # ga.run_block, the eager body, with the default table
    c, mc = _blocks(lambda s, t, w, n, **kw: ga.run_block(s, OBJ, t, w, cfg, GNM, n, **kw),
                    st0._replace(rng=_rng()), blur_sigma=blur)
    assert _same(a, c, 5) and torch.equal(mc, mb)


@pytest.mark.parametrize("kind", ["sa_batched", "sa_sequential", "pt"])
def test_sa_pt_make_run_block_equals_eager_loop(kind):
    cfg = SAConfig(iterations=12, tries_per_iter=3, t0=1e-2,
                   proposal_mode="sequential" if kind == "sa_sequential" else "batched")
    if kind == "pt":
        st0 = pt.init(_rng(3), OBJ, TGT, WM, GNM, 3, t_cold=1e-2, t_hot=1.0)

        def step(s):
            return pt.step(s, OBJ, TGT, WM, cfg, GNM, SIG_MAX, SIG_MIN, 4)

        run, n_t = pt.make_run_block(OBJ, cfg, GNM, swap_every=4), 5
    else:
        st0 = sa.init(_rng(3), OBJ, TGT, WM, GNM)

        def step(s):
            return sa.step(s, OBJ, TGT, WM, cfg, GNM, SIG_MAX, SIG_MIN)

        run, n_t = sa.make_run_block(OBJ, cfg, GNM), 4
    a, ms = st0._replace(rng=_rng()), []
    for _ in range(sum(BLOCKS)):
        a, m = step(a)
        ms.append(m)
    b, mb = _blocks(run, st0._replace(rng=_rng()))
    assert _same(a, b, n_t) and a.it == b.it == sum(BLOCKS)
    assert torch.equal(torch.stack(ms), mb)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def test_adam_make_run_block_equals_step_loop():
    """gradient.make_run_block over blocks of 4, 4, 3 (its first block makes
    Adam's moments) equals make_fit_step's step in a loop, genomes, fits and
    Adam's moments and step in bits; the state comes back with step 11."""
    cfg = GradConfig(lr=2e-2)
    g0 = torch.from_numpy(axes_genomes(23, 2, GNM.n_splats, H, W))
    make_opt, step = gradient.make_fit_step(OBJ, GNM, cfg)
    a, fa = gradient.init_state(make_opt, g0), []
    for _ in range(sum(BLOCKS)):
        a, f = step(a, TGT, WM)
        fa.append(f)
    run = gradient.make_run_block(OBJ, GNM, cfg)
    b, fb = _blocks(run, gradient.init_state(run.make_opt, g0))
    assert torch.equal(a.g, b.g) and torch.equal(torch.stack(fa), fb)
    assert a.step == b.step == sum(BLOCKS)
    sa_, sb = a.opt.state[a.g], b.opt.state[b.g]
    assert all(torch.equal(sa_[k], sb[k]) for k in ("exp_avg", "exp_avg_sq", "step"))


def _fused_state(g, mu, nu, count, cfg):
    """convert.grad_state_from_jax's state with the fused update (what
    make_adam builds on a card, there also capturable)."""
    st = convert.grad_state_from_jax(g, mu, nu, count, cfg, device="cpu")
    opt = torch.optim.Adam([st.g], lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8, fused=True)
    opt.state[st.g] = st.opt.state[st.g]
    return st._replace(opt=opt)


def test_fused_adam_matches_jax_from_carried_state():
    """test_torch_gradient's carried-state check with the fused Adam: five
    steps after two of JAX's, at that test's tolerance (fits rtol 1e-5,
    genomes atol 1e-5 and 2e-5 on the 0-255 columns)."""
    Hc, Wc, N, B = 32, 48, 8, 2
    g0 = axes_genomes(11, B, N, Hc, Wc, 0.3)
    tgt, wm = image(12, Hc, Wc), weights(13, Hc, Wc)
    jobj = jobjective.Objective(H=Hc, W=Wc, impl="xla", precision="exact-tight")
    opt, jstep = jgradient.make_fit_step(
        jobj, JGenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3), JGradConfig(lr=1e-2))
    jstep = jax.jit(jstep)
    js = jgradient.init_state(opt, jnp.asarray(g0))
    for _ in range(2):
        js, _ = jstep(js, jnp.asarray(tgt), jnp.asarray(wm))
    adam = js.opt_state[0]
    ts = _fused_state(np.asarray(js.g), np.asarray(adam.mu), np.asarray(adam.nu),
                      np.asarray(adam.count), GradConfig(lr=1e-2))
    assert ts.opt.param_groups[0]["fused"]
    tobj = objective.Objective(H=Hc, W=Wc, precision="exact-tight")
    _, tstep = gradient.make_fit_step(
        tobj, GenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3), GradConfig(lr=1e-2))
    for _ in range(5):
        js, fj = jstep(js, jnp.asarray(tgt), jnp.asarray(wm))
        ts, ft = tstep(ts, torch.from_numpy(tgt), torch.from_numpy(wm))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)
    gj = np.asarray(js.g)
    np.testing.assert_allclose(ts.g[..., :5].numpy(), gj[..., :5], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.g[..., 5:].numpy(), gj[..., 5:], atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_capturable_adam_on_card_matches_cpu_adam():
    """make_adam on a card (capturable, fused) against the CPU's Adam on the
    same genomes and gradients for ten steps, at test_torch_gradient's
    tolerance; the step count stays on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the capturable Adam has no CPU mode)")
    g0 = torch.from_numpy(axes_genomes(31, 2, 64, H, W))
    cfg = GradConfig(lr=1e-2)
    g_cpu, g_dev = g0.clone(), g0.cuda()
    o_cpu, o_dev = gradient.make_adam(g_cpu, cfg), gradient.make_adam(g_dev, cfg)
    assert o_dev.param_groups[0]["capturable"] and not o_cpu.param_groups[0]["capturable"]
    gen = torch.Generator().manual_seed(32)
    for _ in range(10):
        grad = torch.randn(g0.shape, generator=gen)
        g_cpu.grad, g_dev.grad = grad, grad.cuda()
        o_cpu.step()
        o_dev.step()
    assert o_dev.state[g_dev]["step"].device.type == "cuda"
    np.testing.assert_allclose(g_dev[..., :5].cpu().numpy(), g_cpu[..., :5].numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(g_dev[..., 5:].cpu().numpy(), g_cpu[..., 5:].numpy(), atol=2e-5,
                               rtol=0)


def test_capture_counts_are_replayed():
    """block_graph's launch accounting: a capture's advance of the wrapper
    counters and of a listed tally is set back, and a replay adds it once
    (a tally no longer listed is left alone)."""
    tally = collections.Counter({8: 2})
    block_graph.TALLIES.append(tally)
    k1 = rc.fitness_tiles.launches
    try:
        before = block_graph._snapshot()
        rc.fitness_tiles.launches += 3  # what a captured block's wrappers count
        tally[8] += 3
        tally[1] += 1
        delta = block_graph._take_delta(before)
        assert rc.fitness_tiles.launches == k1 and tally == {8: 2}
        for _ in range(2):
            block_graph._add_delta(delta)
        assert rc.fitness_tiles.launches == k1 + 6 and tally == {8: 8, 1: 2}
        block_graph.TALLIES.remove(tally)
        block_graph._add_delta(delta)
        assert tally == {8: 8, 1: 2}
    finally:
        rc.fitness_tiles.launches = k1
        if tally in block_graph.TALLIES:
            block_graph.TALLIES.remove(tally)


def test_block_graphs_run_the_eager_body_on_the_cpu():
    """On the CPU the helper is its body: no capture, no copies."""
    calls = []

    def body(inp, n, host, rng):
        calls.append((n, host, rng))
        return inp["x"] * n

    graphs = block_graph.BlockGraphs(body)
    x = torch.ones(3)
    assert torch.equal(graphs({"x": x, "y": None}, 4, 7), x * 4)
    assert graphs({"x": x, "y": None}, 4, 8, phase=(1,)).tolist() == [4.0] * 3
    assert calls == [(4, 7, None), (4, 8, None)] and graphs.graphs == {} and graphs.last is None
