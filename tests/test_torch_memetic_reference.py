"""The port's memetic refinement held to the benchmark's plain reference
(portbench/reference_memetic.py), on the CPU at a small size: run_ga's
problem in small (exact-tight, masked MSE, N up to render_cuda.MAX_SPLATS,
so each Adam step of the refinement is one render_grad.fused_value_and_grad
over the elites: K7's route, whose walks take their plain versions here).

* gradient.make_refine, called twice on one elite buffer (the second call
  on other elites: its Adam's moments and step count reset in place),
  against the reference's refinement from fresh moments: the refined
  elites' change by gene column, the first step's gradient, the refined
  energies and the accept decisions.
* A memetic block of refine_every generations against a plain GA block
  and the reference's refinement of its elites: the rows after the elites
  equal in bits, the elites within the same tolerances.
* The memetic cell's driver (portbench/drivers/memetic.py) on a tiny cell:
  the sound program is correct; each of its FAULTS, planted, is not, and
  `grad-altered` only through the refinement's numbers.
* The memetic cell's readers on synthetic records, and None on records of
  another kind or of a program without the ga.refine span and count.
* ga.refine is a published span, and a memetic block counts one
  refinement in profiling.COUNTS["ga.refine"] each time it refines."""
import json
import os
from types import SimpleNamespace

import pytest
import torch

from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig
from ggs_tpu_torch.models import ga, genome, gradient
from ggs_tpu_torch.ops import objective, render_cuda, render_grad
from ggs_tpu_torch.utils import profiling
from portbench import cell, harness, reference_memetic, roofline, run
from portbench.drivers import memetic
from portbench.inputs import ROOT
from torch_inputs import image
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, N, P, E, STEPS, LR = 40, 56, 24, 8, 2, 2, 1e-2
GNM = GenomeConfig(n_splats=N)
OBJ = objective.Objective(H=H, W=W, metric="mse", precision="exact-tight")
# Both sides compute in float32 and differ in the order of their sums (the
# plain walks against the reference's tiles): an energy's relative gap is a
# few ulps (~1e-7 here), a gradient column's norm ~2e-7, the change over two
# steps up to ~3e-6, since Adam divides by the root of the second moment,
# which amplifies rounding where a gradient is small. The same tolerances
# as tests/test_torch_fused_adam_reference.py, under the cell's limits
# (portbench/limits/memetic512-p32.json).
TOL = {"change": 2e-5, "grad": 2e-5, "fit": 2e-5}


def _problem():
    target = torch.from_numpy(image(3, H, W))
    mask = 0.3 + 0.7 * torch.rand(H, W, generator=torch.Generator().manual_seed(4))
    return target, mask


def _elites(seed):
    return genome.new_population(torch.Generator().manual_seed(seed), E, N, H, W, device="cpu")


def _watch(monkeypatch):
    """Records each refinement's first gradient (the fused route's, of the
    mean energy) and the genomes and energies its accept scores."""
    seen = []
    real_fused, real_eval = render_grad.fused_value_and_grad, objective.evaluate

    def fused(*a, **k):
        out = real_fused(*a, **k)
        if not seen or "fits" in seen[-1]:
            seen.append({"grad": out[1].clone()})
        return out

    def evaluate(obj, g, *a, **k):
        out = real_eval(obj, g, *a, **k)
        if seen and "fits" not in seen[-1]:
            seen[-1].update(refined=g.detach().clone(), fits=out.clone())
        return out

    monkeypatch.setattr(render_grad, "fused_value_and_grad", fused)
    monkeypatch.setattr(objective, "evaluate", evaluate)
    return seen


def _gaps(prog, elites, fits, target, mask):
    """prog: one refinement's record -> the gaps against the reference's
    refinement of the same elites from fresh moments, and the accept
    decisions of both."""
    r_refined, r_fits, r_kept, r_grad1 = reference_memetic.refine(elites, fits, target, mask, H, W,
                                                                  STEPS, LR)
    rn = r_grad1.reshape(-1, 9).double().norm(dim=0)
    moved = rn >= 1e-3 * rn.median()
    gaps = {"change": harness.column_gap(prog["refined"] - elites, r_refined - elites, moved),
            "grad": harness.column_gap(prog["grad"] * E, r_grad1),
            "fit": harness.rel_gap(prog["fits"], r_fits)}
    return gaps, prog["fits"] < fits, r_kept


@pytest.mark.parametrize("stale", [False, True], ids=["make_refine", "stale-moments"])
def test_make_refine_twice_on_one_buffer_against_the_reference(stale, monkeypatch):
    """The program's refinement within every tolerance on both calls; the
    stale-moments fault's (the driver's copy of make_refine that does not
    reset them) within them on the first call and not on the second."""
    assert N <= render_cuda.MAX_SPLATS
    target, mask = _problem()
    seen = _watch(monkeypatch)
    make = memetic._make_refine(reset=False) if stale else gradient.make_refine
    refine = make(OBJ, GNM, GradConfig(lr=LR), STEPS)
    for k, seed in enumerate((5, 6)):  # the second call: other elites, moments reset
        elites = _elites(seed)
        fits = objective.evaluate(OBJ, elites, target, mask, device="cpu")
        out, out_fits = refine(elites, fits, target, mask)
        prog = seen[-1]
        gaps, kept, r_kept = _gaps(prog, elites, fits, target, mask)
        if stale and k == 1:
            assert gaps["change"] > TOL["change"], gaps
            return
        assert all(gaps[x] <= TOL[x] for x in TOL), (k, gaps)
        assert torch.equal(kept, r_kept) and bool(kept.any())
        assert torch.equal(out, torch.where(kept[:, None, None], prog["refined"], elites))
        assert torch.equal(out_fits, torch.where(kept, prog["fits"], fits))


def _ga_start(target, mask, gens):
    cfg = GAConfig(pop_size=P, elite_k=E, generations=200)
    st = ga.init(torch.Generator().manual_seed(7), OBJ, target, mask, cfg, GNM)
    if gens:
        st, _ = ga.make_run_block(OBJ, cfg, GNM)(st, target, mask, gens)
    return cfg, st


def test_a_memetic_block_is_a_plain_block_and_the_reference_refinement(monkeypatch):
    target, mask = _problem()
    every = 3
    cfg, st = _ga_start(target, mask, every)  # starts at a generation that every divides
    gen_state = st.rng.get_state()
    a, _ = ga.make_run_block(OBJ, cfg, GNM)(st, target, mask, every)
    seen = _watch(monkeypatch)
    st.rng.set_state(gen_state)
    b, _ = ga.make_memetic_run_block(OBJ, cfg, GNM, GradConfig(lr=LR), every, STEPS)(
        st, target, mask, every)
    assert len(seen) == 1  # one refinement, after the last generation
    assert torch.equal(b.pop[E:], a.pop[E:]) and torch.equal(b.fits[E:], a.fits[E:])
    gaps, kept, r_kept = _gaps(seen[0], a.pop[:E], a.fits[:E], target, mask)
    assert all(gaps[x] <= TOL[x] for x in TOL), gaps
    assert torch.equal(kept, r_kept)
    assert torch.equal(b.pop[:E], torch.where(kept[:, None, None], seen[0]["refined"], a.pop[:E]))


def _tiny_cell():
    with open(os.path.join(ROOT, "portbench", "configs", "photo-512-n512-memetic.json")) as fh:
        cfg = json.load(fh)
    cfg.update(height=H, width=W, n_splats=N, target={"kind": "natural"})
    cfg["ga"]["elite_k"] = E
    cfg["memetic"].update(every=2, steps=STEPS)
    # more warm blocks than two, as the cell's: the refinement check starts
    # after the second, not where the warm blocks end
    traffic = {"driver": "memetic", "pop_size": P, "block": 4, "warm_blocks": 3,
               "trace_blocks": 1, "check_samples": P, "count_tile_h": 8, "grad_count_tile_h": 8}
    with open(os.path.join(ROOT, "portbench", "limits", "memetic512-p32.json")) as fh:
        limits = json.load(fh)
    return cell.Cell(name="tiny-memetic", chips=1, config=cfg, traffic=traffic, limits=limits,
                     end_to_end=[], per_layer=[])


REFINE_CHECKS = ("refine_rest_gap", "refine_accept_gap", "refine_change_gap", "refine_grad_gap",
                 "refine_fit_gap", "refine_kept_diff", "block_eager_gap")
# the faults that only the accept's numbers can see: the refinement's own
# numbers read what it computed before the accept
ACCEPT_FAULTS = {"discards-refinement": {"refine_accept_gap", "refine_kept_diff"},
                 "best-not-updated": {"refine_accept_gap"}}


@pytest.mark.parametrize("fault", [None, "control"] + sorted(memetic.FAULTS))
def test_the_driver_is_correct_and_each_fault_is_not(fault, monkeypatch):
    """The control (the program's bfloat16 fitness, the reference's
    refinement in bfloat16 in the program's place) breaks the fits and the
    refinement's numbers alike, and not the block's bits. The refinement
    check starts where the warm blocks end, where the reference keeps
    refined elites, so an accept that discards them shows."""
    if fault in memetic.FAULTS:
        memetic.FAULTS[fault](monkeypatch)
    out = run.run_cell(_tiny_cell(), 11, 0.05, False, device="cpu", control=fault == "control")
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert out["correct"] == (fault is None), out["checks"]
    if fault == "grad-altered":  # the GA's own numbers cannot see it
        assert over and over <= set(REFINE_CHECKS), out["checks"]
    if fault == "control":
        assert {"fit_gap", "refine_change_gap", "refine_grad_gap"} <= over, out["checks"]
    if fault in ACCEPT_FAULTS:
        assert over == ACCEPT_FAULTS[fault], out["checks"]


def test_the_fault_free_refine_copy_equals_make_refine():
    """The faults' make_refine, with neither flaw, is the program's."""
    target, mask = _problem()
    elites = _elites(5)
    fits = objective.evaluate(OBJ, elites, target, mask, device="cpu")
    want = gradient.make_refine(OBJ, GNM, GradConfig(lr=LR), STEPS)(elites, fits, target, mask)
    got = memetic._make_refine()(OBJ, GNM, GradConfig(lr=LR), STEPS)(elites, fits, target, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


SELF_S = {"block.replay/ga.step/objective.evaluate/render.walk": 0.05,
          "block.replay/ga.refine/adam.step/adam.value_and_grad/render.grad": 0.04,
          "block.replay/ga.refine/objective.evaluate": 0.01, "block.replay/ga.step": 0.02}


def _record(kind="ga", self_s=SELF_S, **extra):
    by_kernel = {"K1": 0.05, "K7": 0.038, "K6-K7-sums": 0.002, "other": 0.03}
    trace = {"units": 100, "by_kernel": by_kernel, "busy_s": 0.12, "window_s": 0.15,
             "spans": {"spans_seen": 40, "self_s": dict(self_s)}, **extra}
    return SimpleNamespace(kind=kind, trace=trace, H=384, W=512, n_splats=512)


GRAD = {"grad_walks": 400, "grad_pair_px": 2.0e8, "grad_pair_cols": 1.0e6,
        "refine_nodes_per_refine": 2236.0}
FWD = {"pair_px": 3.0e9, "pair_cols": 1.5e7, "renders": 3200, "accepts": 10,
       "accept_renders": 80, "accept_pair_px": 8.0e7, "accept_pair_cols": 4.0e5}


def test_the_memetic_readers_on_a_record():
    rec = _record(**GRAD)
    assert cell.reader("refine_ms_per_gen")(rec) == pytest.approx(1e3 * 0.05 / 100)
    assert cell.reader("refine_nodes_per_refine")(rec) == 2236.0
    least = roofline.gradient_least_s(2.0e8, 1.0e6, 400, 384, 512, 512)
    assert cell.reader("fused_walk_roofline_pct.memetic")(rec) == pytest.approx(
        100 * least / 0.040)
    assert cell.reader("idle_pct.memetic")(rec) == pytest.approx(20.0)


def test_the_forward_roofline_counts_the_accepts():
    """fwd_walk_roofline_pct.memetic: K1's time over the least time of the
    GA's renders and the accepts' together; the base reader counts the
    GA's alone."""
    rec = _record(**FWD)
    least = roofline.forward_least_s(3.0e9 + 8.0e7, 1.5e7 + 4.0e5, 3200 + 80, 100 + 10,
                                     384, 512, 512)
    assert cell.reader("fwd_walk_roofline_pct.memetic")(rec) == pytest.approx(100 * least / 0.05)
    assert cell.reader("fwd_walk_roofline_pct.memetic")(rec) > cell.reader(
        "fwd_walk_roofline_pct")(rec)


@pytest.mark.parametrize("reader", ["refine_ms_per_gen", "refine_nodes_per_refine",
                                    "fused_walk_roofline_pct.memetic",
                                    "fwd_walk_roofline_pct.memetic"])
def test_the_memetic_readers_read_nothing_elsewhere(reader):
    read = cell.reader(reader)
    assert read(_record(kind="adam", **GRAD, **FWD)) is None
    assert read(SimpleNamespace(kind="ga", trace=None)) is None
    # a GA record of a program that opens no ga.refine span and counts no
    # refinement, and traced no refinement's walks
    plain = {p: v for p, v in SELF_S.items() if "ga.refine" not in p}
    assert read(_record(self_s=plain)) is None


def test_ga_refine_is_a_span_and_a_count():
    assert "ga.refine" in profiling.SPANS
    target, mask = _problem()
    cfg, st = _ga_start(target, mask, 0)
    run_block = ga.make_memetic_run_block(OBJ, cfg, GNM, GradConfig(lr=LR), 2, STEPS)
    before = profiling.COUNTS["ga.refine"]
    st, _ = run_block(st, target, mask, 5)  # refines after generations 2 and 4
    assert profiling.COUNTS["ga.refine"] - before == 2
    st, _ = run_block(st, target, mask, 1)  # generation 6
    assert profiling.COUNTS["ga.refine"] - before == 3
