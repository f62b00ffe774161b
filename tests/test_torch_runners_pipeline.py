"""The port's run_pipeline, the staged and annealed run_ga, run_grad
--anneal-sigma0, run_sa's frames, make_video and the procedural targets, on
the CPU at 40x200, where every kernel wrapper takes its plain version. The
targets are numpy on both sides and must equal the JAX package's arrays;
the animations must decode to their frame PNGs."""
import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ggs_tpu.utils import io as jio
from ggs_tpu_torch import make_video, run_ga, run_grad, run_pipeline, run_sa
from ggs_tpu_torch.utils import io as tio
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

IMG = ["--image", "synthetic:40x200", "--work-max-side", "200", "--device", "cpu"]
GA = IMG + ["--n-splats", "16", "--pop-size", "4", "--elite-k", "1", "--log-every", "4"]


def _frames_equal_animation(frames_dir, prefix, anim):
    frames = sorted(glob.glob(os.path.join(frames_dir, f"{prefix}_*.png")))
    assert frames
    im = Image.open(anim)
    assert im.n_frames == len(frames) and im.info.get("loop") == 0
    for i, f in enumerate(frames):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      np.asarray(Image.open(f).convert("RGB")))
    return frames


def _monotone_within_stages(out):
    for st in out["stages"]:
        best = st["curves"]["best"]
        assert len(best) == st["generations"] + 1
        assert all(b1 <= b0 for b0, b1 in zip(best, best[1:]))


@pytest.mark.parametrize("grow", [["--grow-patience", "3"],
                                  ["--grow-mode", "stages", "--grow-stages", "3", "--no-video"]])
def test_run_pipeline_cpu(grow, tmp_path):
    out = run_pipeline.main(IMG + [
        "--n-splats", "32", "--pop-size", "4", "--elite-k", "1", "--ga-generations", "24",
        "--recycle-every", "5", "--adam-steps", "6", "--output-dir", str(tmp_path), *grow,
    ])
    ga_out, grad_out = out["ga"], out["grad"]
    sizes = [st["n_splats"] for st in ga_out["stages"]]
    assert sizes == [8, 16, 32]  # from n-splats / 8 (auto) or / 2^(S-1) (stages), doubling
    assert sum(st["generations"] for st in ga_out["stages"]) <= 24
    _monotone_within_stages(ga_out)
    curve = grad_out["curve"]
    assert len(curve) == 6 and curve[-1] < curve[0]
    assert np.load(tmp_path / "grad_genome.npy").shape == (32, 9)
    if "--no-video" not in grow:
        _frames_equal_animation(tmp_path / "video_frames", "ga", tmp_path / "ga_anim.apng")


def test_run_ga_anneal_cpu(tmp_path):
    out = run_ga.main(GA + ["--generations", "20", "--anneal-sigma0", "4", "--anneal-frac", "0.5",
                            "--no-video", "--output-dir", str(tmp_path)])
    best = out["curves"]["best"]
    assert len(best) == 21 and np.isfinite(out["best_fit"]) and 0 < out["best_fit"] < 1
    # sigma steps at the blocks starting at generations 0, 4 and 8, and snaps
    # to 0 at 12: the curve holds the smoothed landscapes' energies up to
    # generation 12, then the exact objective's (gens 13-20), monotone
    assert all(b1 <= b0 for b0, b1 in zip(best[13:], best[14:]))
    assert len(set(best[1:13])) > 1
    assert not (tmp_path / "video_frames").exists()


def test_run_ga_recycle_cpu(tmp_path):
    out = run_ga.main(GA + ["--generations", "16", "--recycle-every", "4", "--recycle-k", "3",
                            "--recycle-patience", "2", "--no-video",
                            "--output-dir", str(tmp_path)])
    best = out["curves"]["best"]
    assert len(best) == 17 and all(b1 <= b0 for b0, b1 in zip(best, best[1:]))


def test_run_ga_progressive_fixed_mask_cpu(tmp_path):
    out = run_ga.main(GA + ["--generations", "12", "--progressive", "100,200", "--fixed-mask",
                            "--no-video", "--output-dir", str(tmp_path)])
    assert [st["work"] for st in out["stages"]] == [(20, 100), (40, 200)]
    assert [st["generations"] for st in out["stages"]] == [6, 6]
    assert tuple(out["final"].shape) == (40, 200, 3)
    assert (tmp_path / "ga_loss_s0.csv").exists() and (tmp_path / "ga_loss.csv").exists()


def test_run_grad_anneal_cpu(tmp_path):
    out = run_grad.main(IMG + ["--n-splats", "16", "--steps", "12", "--log-every", "3",
                               "--anneal-sigma0", "4", "--output-dir", str(tmp_path)])
    curve = out["curve"]
    assert len(curve) == 12 and np.isfinite(out["best_loss"]) and 0 < out["best_loss"] < 1
    assert curve[-1] < curve[0]


def test_frames_and_make_video_cpu(tmp_path):
    """run_ga and run_sa write frames by default; their animations and
    make_video's decode to exactly those frames."""
    run_ga.main(GA + ["--generations", "8", "--video-len", "1", "--fps", "2",
                      "--output-dir", str(tmp_path / "ga")])
    frames = _frames_equal_animation(tmp_path / "ga" / "video_frames", "ga",
                                     tmp_path / "ga" / "ga_anim.apng")
    assert [os.path.basename(f) for f in frames] == ["ga_0.png", "ga_4.png", "ga_8.png"]
    run_sa.main(IMG + ["--n-splats", "12", "--iterations", "6", "--log-every", "3",
                       "--video-len", "1", "--fps", "3", "--output-dir", str(tmp_path / "sa")])
    _frames_equal_animation(tmp_path / "sa" / "video_frames_sa", "sa",
                            tmp_path / "sa" / "sa_anim.apng")
    out = make_video.main([str(tmp_path / "ga" / "video_frames"), "--fps", "5"])
    assert out == str(tmp_path / "ga" / "ga_anim.apng")
    _frames_equal_animation(tmp_path / "ga" / "video_frames", "ga", out)
    # a frame of another size is skipped
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "ga" / "video_frames" / "ga_9.png")
    im = Image.open(make_video.main([str(tmp_path / "ga" / "video_frames"), "--out",
                                     str(tmp_path / "x.apng")]))
    assert im.n_frames == len(frames)
    with pytest.raises(SystemExit):
        make_video.main([str(tmp_path / "ga" / "video_frames"), "--prefix", "none"])


@pytest.mark.parametrize("argv", [
    ["--progressive", "20,40", "--grow-auto"],
    ["--progressive", "20,40", "--grow-stages", "2"],
    ["--grow-auto", "--grow-stages", "2"],
])
def test_run_ga_refuses_what_jax_refuses(argv, tmp_path):
    with pytest.raises(SystemExit):
        run_ga.main(GA + ["--generations", "2", "--output-dir", str(tmp_path), *argv])


def test_memetic_and_anneal_are_exclusive(tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_ga.main(GA + ["--generations", "2", "--memetic-every", "1", "--anneal-sigma0", "2",
                          "--no-video", "--output-dir", str(tmp_path)])


@pytest.mark.parametrize("family", ["gradient", "portrait", "texture", "text", "natural"])
def test_quality_targets_equal_jax(family):
    for h, w in ((40, 200), (96, 64)):
        np.testing.assert_array_equal(tio.quality_target(family, h, w),
                                      jio.quality_target(family, h, w))
    np.testing.assert_array_equal(tio.load_image(f"{family}:24x30"),
                                  jio.load_image(f"{family}:24x30"))


def test_photo_target_equal_jax():
    for name in ("photo", "photo:40x200"):
        got = tio.load_image(name)
        np.testing.assert_array_equal(got, jio.load_image(name))
        assert got.dtype == np.float32 and 0.0 <= got.min() and got.max() <= 1.0
    with pytest.raises(ValueError):
        tio.quality_target("mosaic", 8, 8)
    assert torch.as_tensor(tio.load_image("photo")).shape == (512, 512, 3)
