"""A run's check, driven on the CPU at a tiny size with the timed path
broken underneath: each fault that a cell can have makes `correct` false,
and the sound program makes it true. (A run on the CPU skips the harness's
look for a card: run_cell is called directly.)"""
import json
import os

import pytest
import torch

from portbench import cell as cell_mod
from portbench import run
from portbench.faults import FAULTS

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cell(kind):
    with open(os.path.join(HERE, "configs", "flagship-1024-n10k.json")) as fh:
        cfg = json.load(fh)
    cfg.update(height=24, width=32, n_splats=12)
    if kind == "ga":
        traffic = {"driver": "ga", "pop_size": 8, "block": 2, "warm_blocks": 2,
                   "trace_blocks": 1, "check_samples": 8, "count_tile_h": 8}
        limits = {"fit_gap": 1e-4, "repeats": 0}
    else:
        traffic = {"driver": "adam", "splat_seed": 5, "lr": 0.01, "block": 4, "warm_blocks": 2,
                   "trace_blocks": 1, "count_tile_h": 8}
        limits = {"loss_gap": 1e-4, "grad_gap": 1e-2, "change_gap": 1e-2, "block_loss_gap": 1e-4,
                  "end_grad_gap": 1e-2, "block_change_gap": 1e-2, "block_eager_gap": 0}
    return cell_mod.Cell(name=f"tiny-{kind}", chips=1, config=cfg, traffic=traffic,
                         limits=limits, end_to_end=[], per_layer=[])


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """Passes of 7 splats, so the 12-splat Adam cell chains its passes and
    takes the autograd value and gradient (K2' and K6), as at 10,000."""
    from ggs_tpu_torch.ops import render_cuda

    monkeypatch.setattr(render_cuda, "MAX_SPLATS", 7)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _correct(kind, seed=11):
    out = run.run_cell(_cell(kind), seed, 0.05, False, device="cpu")
    return out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["ga", "adam"])
def test_sound_program_is_correct(kind):
    ok, checks = _correct(kind)
    assert ok, checks


@pytest.mark.parametrize("kind,fault", [(k, f) for k in ("ga", "adam") for f in FAULTS[k]])
def test_a_fault_makes_the_run_incorrect(kind, fault, monkeypatch):
    FAULTS[kind][fault](monkeypatch)
    ok, checks = _correct(kind)
    assert not ok, checks
