"""The port's run_ga and run_sa with checkpoints and resume, run_ga's island
model and its profile trace, on the CPU at a small size, where every kernel
wrapper takes its plain version.

A run is stopped after one of its checkpoints and resumed from it with the
same flags: the mutation sigmas anneal over --generations, so a stop must
keep the budget (a run given fewer generations is another trajectory). The
in-process stop raises KeyboardInterrupt right after that save, which the
host loops catch as a user's Ctrl-C; the crash test SIGKILLs a subprocess
(tests/test_crash_recovery.py's, at a size that takes seconds here)."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from ggs_tpu_torch import run_ga, run_sa
from ggs_tpu_torch.utils import checkpoint as ckpt
from ggs_tpu_torch.utils import profiling
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GA = ["--image", "synthetic:32x32", "--work-max-side", "32", "--n-splats", "16", "--pop-size",
      "8", "--elite-k", "2", "--log-every", "5", "--no-video", "--device", "cpu"]
SA = ["--image", "synthetic:32x32", "--work-max-side", "32", "--n-splats", "12",
      "--tries-per-iter", "3", "--t0", "1e-2", "--log-every", "4", "--no-video",
      "--device", "cpu"]


def _stop_after_save(monkeypatch, key, at):
    """checkpoint.save_checkpoint raises KeyboardInterrupt after the save
    whose meta[key] is `at`."""
    save = ckpt.save_checkpoint

    def stop(path, state, meta=None):
        save(path, state, meta)
        if meta[key] == at:
            raise KeyboardInterrupt

    monkeypatch.setattr(ckpt, "save_checkpoint", stop)


def _rows(path):
    return len(open(path).read().strip().splitlines()) - 1


@pytest.mark.parametrize("extra", [[], ["--islands", "2", "--migrate-every", "3",
                                        "--migrate-k", "2"]], ids=["plain", "islands"])
def test_run_ga_resume_equals_uninterrupted(tmp_path, monkeypatch, extra):
    argv = GA + ["--generations", "20", *extra]
    full = run_ga.main(argv + ["--output-dir", str(tmp_path / "full")])
    out = tmp_path / "stopped"
    with monkeypatch.context() as m:
        _stop_after_save(m, "gen", 10)
        run_ga.main(argv + ["--checkpoint-every", "5", "--output-dir", str(out)])
    with np.load(out / "ga_ckpt.npz", allow_pickle=False) as z:
        assert json.loads(str(z["__meta__"]))["meta"]["gen"] == 10
    resumed = run_ga.main(argv + ["--resume", str(out / "ga_ckpt.npz"),
                                  "--output-dir", str(out)])
    np.testing.assert_array_equal(np.load(out / "ga_best_genome.npy"),
                                  np.load(tmp_path / "full" / "ga_best_genome.npy"))
    assert resumed["curves"] == full["curves"]
    assert _rows(out / "ga_loss.csv") == _rows(tmp_path / "full" / "ga_loss.csv") == 21


@pytest.mark.parametrize("extra", [[], ["--replicas", "4", "--swap-every", "2"]],
                         ids=["sa", "pt"])
def test_run_sa_resume_equals_uninterrupted(tmp_path, monkeypatch, extra):
    argv = SA + ["--iterations", "16", *extra]
    full = run_sa.main(argv + ["--output-dir", str(tmp_path / "full")])
    out = tmp_path / "stopped"
    with monkeypatch.context() as m:
        _stop_after_save(m, "it", 8)
        run_sa.main(argv + ["--checkpoint-every", "4", "--output-dir", str(out)])
    resumed = run_sa.main(argv + ["--resume", str(out / "sa_ckpt.npz"),
                                  "--output-dir", str(out)])
    np.testing.assert_array_equal(np.load(out / "sa_best_genome.npy"),
                                  np.load(tmp_path / "full" / "sa_best_genome.npy"))
    assert resumed["curves"] == full["curves"] and len(full["curves"]["best"]) == 17


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    env["OMP_NUM_THREADS"] = "1"  # one intra-op thread, as one_torch_thread sets in-process
    return env


def test_sigkill_then_resume(tmp_path):
    """A run_ga process killed with SIGKILL after a checkpoint resumes from it
    and finishes with its artifacts and the whole budget's curve rows."""
    out = tmp_path / "out"
    base = [sys.executable, "-m", "ggs_tpu_torch.run_ga", *GA, "--generations", "200",
            "--checkpoint-every", "50", "--output-dir", str(out)]
    ck = out / "ga_ckpt.npz"
    p = subprocess.Popen(base, env=_env(), cwd=_REPO, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 20
        while time.time() < deadline and not ck.exists():
            assert p.poll() is None, f"run exited early rc={p.returncode}"
            time.sleep(0.05)
        assert ck.exists(), "no checkpoint appeared before the kill"
        p.send_signal(signal.SIGKILL)  # hard crash: no cleanup, no flush
        p.wait(timeout=20)
    finally:
        if p.poll() is None:
            p.kill()
    # the save is atomic: the file is a whole checkpoint, and no temporary is left
    assert sorted(f.name for f in out.iterdir() if f.suffix == ".tmp") == []
    with np.load(ck, allow_pickle=False) as z:
        crashed_gen = int(json.loads(str(z["__meta__"]))["meta"]["gen"])
    assert 50 <= crashed_gen < 200 and crashed_gen % 50 == 0
    r = subprocess.run(base + ["--resume", str(ck)], env=_env(), cwd=_REPO, capture_output=True,
                       text=True, timeout=30)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (out / "ga_splats.png").exists() and (out / "ga_best_genome.npy").exists()
    # the resumed run continued from the checkpoint: its curves cover the
    # whole budget, the checkpoint's rows included
    assert _rows(out / "ga_loss.csv") == 201
    assert f"ga gen {crashed_gen + 5}/200" in r.stdout and "ga gen 5/200" not in r.stdout


def test_run_ga_islands_monotone(tmp_path):
    out = run_ga.main(GA + ["--generations", "30", "--islands", "2", "--migrate-every", "5",
                            "--output-dir", str(tmp_path)])
    best = out["curves"]["best"]
    assert len(best) == 31 and best[-1] < best[0]
    assert all(b1 <= b0 for b0, b1 in zip(best, best[1:]))
    with pytest.raises(ValueError, match="even size"):
        run_ga.main(GA + ["--generations", "2", "--pop-size", "12", "--islands", "4",
                          "--output-dir", str(tmp_path)])


def test_profile_dir_writes_trace(tmp_path):
    """run_ga --profile-dir traces the first block after the start block."""
    prof = tmp_path / "prof"
    run_ga.main(GA + ["--generations", "15", "--profile-dir", str(prof),
                      "--output-dir", str(tmp_path / "out")])
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "ga block 5-10" for e in events)


def test_trace_noop():
    """trace(None) and trace("") trace nothing, as ggs_tpu.utils.profiling's."""
    with profiling.trace(None):
        pass
    with profiling.trace(""):
        pass
