"""The port's run_sa (every proposal mode, tier and metric, and parallel
tempering) and run_grad under --metric mix, on the CPU at 40x200, where
every kernel wrapper takes its plain version."""
import numpy as np
import pytest
import torch

from ggs_tpu_torch import run_grad, run_sa
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

BASE = ["--image", "synthetic:40x200", "--work-max-side", "200", "--n-splats", "12",
        "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    [],
    ["--proposal-mode", "sequential"],
    ["--replicas", "3", "--swap-every", "2"],
    ["--precision", "fast", "--cull-eps", "8e-2"],
    ["--precision", "bf16"],
    ["--precision", "highest", "--metric", "ssim"],
    ["--precision", "bf16", "--metric", "mix", "--replicas", "2"],
    ["--impl", "oracle", "--metric", "mix", "--ssim-weight", "0.2", "--proposal-mode", "sequential"],
])
def test_run_sa_cpu(extra, tmp_path):
    out = run_sa.main(BASE + [
        "--iterations", "6", "--tries-per-iter", "3", "--log-every", "3", "--t0", "1e-2",
        "--no-video", "--output-dir", str(tmp_path), *extra,
    ])
    best, curr = out["curves"]["best"], out["curves"]["current"]
    assert len(best) == len(curr) == 7
    assert np.all(np.diff(best) <= 0.0) and all(b <= c + 1e-7 for b, c in zip(best, curr))
    assert np.isfinite(out["best_fit"]) and 0.0 < out["best_fit"] < 1.0
    assert tuple(out["final"].shape) == (40, 200, 3) and bool(torch.isfinite(out["final"]).all())
    assert np.load(tmp_path / "sa_best_genome.npy").shape == (12, 9)
    assert (tmp_path / "sa_splats.png").exists() and (tmp_path / "sa_loss.csv").exists()


def test_run_sa_refuses_what_is_not_ported(tmp_path):
    """Checkpoints are ported: run_sa writes one and refuses to resume it
    as another state (an SA chain's file into parallel tempering)."""
    base = BASE + ["--iterations", "2", "--log-every", "1", "--no-video",
                   "--output-dir", str(tmp_path)]
    run_sa.main(base + ["--checkpoint-every", "1"])
    with pytest.raises(ValueError, match="state type mismatch"):
        run_sa.main(base + ["--replicas", "3", "--resume", str(tmp_path / "sa_ckpt.npz")])
    if not torch.cuda.is_available():  # no fallback to the CPU without a card
        with pytest.raises(RuntimeError, match="cuda"):
            run_sa.main(["--image", "synthetic:40x200", "--iterations", "1", "--no-video"])


def test_run_grad_metric_mix_cpu(tmp_path):
    out = run_grad.main(BASE[:4] + [
        "--n-splats", "16", "--steps", "6", "--log-every", "3", "--metric", "mix",
        "--ssim-weight", "0.4", "--device", "cpu", "--output-dir", str(tmp_path),
    ])
    curve = out["curve"]
    assert len(curve) == 6 and curve[-1] < curve[0]
    assert np.isfinite(out["best_loss"]) and 0.0 < out["best_loss"] < 1.0
    assert (tmp_path / "grad_splats.png").exists() and (tmp_path / "grad_loss.csv").exists()
