"""The port's fused Adam route held to the benchmark's plain reference, on
the CPU.

`gradient.make_run_block` takes three eager one-step calls on a seeded
genome of run_grad's problem in small (exact-tight, masked MSE, N up to
render_cuda.MAX_SPLATS, so one `render_grad.fused_value_and_grad` a step:
K7's route, whose walks take their plain versions here), and
`portbench.reference.follow_adam` follows the same three steps from the
same genome and fresh moments. The numbers compared are those of the Adam
cells' check (portbench/drivers/adam.py): the three energies, the first
gradient (Adam's first moment over 1 - beta1) and the genome's change over
the three steps, by gene column."""
from types import SimpleNamespace

import pytest
import torch

from ggs_tpu_torch.config import GenomeConfig, GradConfig
from ggs_tpu_torch.models import genome, gradient
from ggs_tpu_torch.ops import objective, render_cuda, render_grad
from portbench import cell, harness, reference, roofline
from portbench.faults_fused import FUSED_FAULTS
from torch_inputs import image
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, N, LR = 40, 56, 24, 1e-2  # 40 rows: the last 16-row list tile is padded
# The tolerances sit between two sets of H100 readings of run_grad's default
# problem (384x512, 2,000 splats, K7's route, the Adam driver's check): the
# largest of 33 sound runs (6.1e-7, 5.1e-7, 3.7e-6) and the least of the
# bfloat16 reference and the faults (8.0e-4, 1.0e-3, 6.7e-5), among them
# portbench/faults_fused.py's, which the test below plants here too.
# The port and the reference both compute in float32 and differ only in the
# order of their sums: an energy's relative gap is a few ulps (~1e-7 here),
# a gradient column's norm ~2e-7, the change over three steps ~2e-6, since
# Adam divides by the root of the second moment, which amplifies rounding
# where a gradient is small. The reference in bfloat16 reads 5e-4, 7e-3 and
# 2e-3 here.
TOL = {"loss_gap": 2e-5, "grad_gap": 2e-5, "change_gap": 2e-5}


def _problem():
    g0 = genome.new_population(torch.Generator().manual_seed(5), 1, N, H, W, device="cpu")
    target = torch.from_numpy(image(3, H, W))
    mask = 0.3 + 0.7 * torch.rand(H, W, generator=torch.Generator().manual_seed(4))
    return g0, target, mask


def _program(g0, target, mask, monkeypatch):
    """Three eager one-step calls of the port's Adam block -> (the three
    energies, the first gradient, the genome after three steps, the
    number of fused and autograd value-and-gradient calls)."""
    calls = {"fused": 0, "autograd": 0}
    real_fused, real_loss_fn = render_grad.fused_value_and_grad, gradient.make_loss_fn

    def fused(*a, **k):
        calls["fused"] += 1
        return real_fused(*a, **k)

    def make_loss_fn(*a, **k):
        loss_fn = real_loss_fn(*a, **k)

        def counted(*b, **kb):
            calls["autograd"] += 1
            return loss_fn(*b, **kb)

        return counted

    monkeypatch.setattr(render_grad, "fused_value_and_grad", fused)
    monkeypatch.setattr(gradient, "make_loss_fn", make_loss_fn)
    obj = objective.Objective(H=H, W=W, metric="mse", precision="exact-tight")
    run = gradient.make_run_block(obj, GenomeConfig(n_splats=N), GradConfig(lr=LR))
    state = gradient.init_state(run.make_opt, g0)
    energies = []
    for i in range(3):
        state, fits = run.eager(state, target, mask, 1)
        energies.append(float(fits[0, 0]))
        if i == 0:
            moment1 = state.opt.state[state.g]["exp_avg"].clone()
    grad1 = moment1 / (1.0 - state.opt.param_groups[0]["betas"][0])
    return energies, grad1, state.g.detach().clone(), calls


def _gaps(energies, grad1, g3, g0, target, mask, dtype=torch.float32):
    """The Adam check's three start numbers against the reference in `dtype`."""
    losses, grad_ref, g3_ref = reference.follow_adam(g0[0], target, mask, H, W, 3, LR,
                                                     dtype=dtype)
    rn = grad_ref.reshape(-1, 9).double().norm(dim=0)
    moved = rn >= 1e-3 * rn.median()  # columns moved beyond rounding, as the Adam check takes them
    return {"loss_gap": harness.rel_gap(energies, losses),
            "grad_gap": harness.column_gap(grad1, grad_ref),
            "change_gap": harness.column_gap(g3 - g0, g3_ref - g0[0], moved)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_fused_adam_steps_against_the_reference(dtype, monkeypatch):
    """float32: every gap within its tolerance; the reference in bfloat16
    (the Adam cells' control) breaks at least one."""
    assert N <= render_cuda.MAX_SPLATS
    g0, target, mask = _problem()
    energies, grad1, g3, calls = _program(g0, target, mask, monkeypatch)
    assert calls == {"fused": 3, "autograd": 0}  # K7's route, never the chained one
    gaps = _gaps(energies, grad1, g3, g0, target, mask, dtype)
    within = {k: gaps[k] <= TOL[k] for k in TOL}
    if dtype == torch.float32:
        assert all(within.values()), gaps
    else:
        assert not all(within.values()), gaps


@pytest.mark.parametrize("fault", sorted(FUSED_FAULTS))
def test_a_fault_on_the_fused_route_breaks_a_tolerance(fault, monkeypatch):
    g0, target, mask = _problem()
    FUSED_FAULTS[fault](monkeypatch)
    energies, grad1, g3, calls = _program(g0, target, mask, monkeypatch)
    assert calls["fused"] == 3
    gaps = _gaps(energies, grad1, g3, g0, target, mask)
    assert any(gaps[k] > TOL[k] for k in TOL), gaps


def _record(kind, by_kernel):
    trace = {"by_kernel": by_kernel, "units": 100, "pair_px": 3.0e8, "pair_cols": 2.0e6}
    return SimpleNamespace(kind=kind, trace=trace, H=384, W=512, n_splats=2000)


FUSED_STEP = {"K7": 0.040, "K6-K7-sums": 0.002, "sort.int": 0.003, "K5": 0.0, "other": 0.050}
CHAINED_STEP = {"K6": 0.300, "K6-K7-sums": 0.010, "K2": 0.050, "K5": 0.004, "other": 0.080}


def test_the_fused_route_readers_on_a_fused_record():
    """fused_walk_roofline_pct reads K7 and its sums and nothing else;
    adam_other_ms_per_step.n2000 leaves out exactly K7, its sums and the
    integer sorts."""
    rec = _record("adam", dict(FUSED_STEP))
    least = roofline.gradient_least_s(3.0e8, 2.0e6, 100, 384, 512, 2000)
    assert cell.reader("fused_walk_roofline_pct")(rec) == pytest.approx(100 * least / 0.042)
    assert cell.reader("adam_other_ms_per_step.n2000")(rec) == pytest.approx(1e3 * 0.050 / 100)
    rec.trace["by_kernel"]["K2"] = 0.5  # neither K7 nor its sums: "other" work to both readers
    assert cell.reader("fused_walk_roofline_pct")(rec) == pytest.approx(100 * least / 0.042)
    assert cell.reader("adam_other_ms_per_step.n2000")(rec) == pytest.approx(1e3 * 0.550 / 100)


@pytest.mark.parametrize("reader", ["fused_walk_roofline_pct", "adam_other_ms_per_step.n2000"])
@pytest.mark.parametrize("kind,by_kernel", [
    ("ga", {"K1": 0.5, "sort.int": 0.01, "other": 0.1}),
    ("adam", CHAINED_STEP),  # the chained route: no K7
], ids=["ga", "chained-adam"])
def test_the_fused_route_readers_read_nothing_without_k7(reader, kind, by_kernel):
    assert cell.reader(reader)(_record(kind, by_kernel)) is None
    assert cell.reader(reader)(SimpleNamespace(kind="adam", trace=None)) is None
