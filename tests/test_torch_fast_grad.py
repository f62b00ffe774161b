"""The fast tier through the port's gradient paths and runners
(ggs_tpu_torch/ops/render_grad.py with cull_eps/corner_cull,
models/gradient.py under precision "fast", the memetic GA, run_ga
--precision fast|bf16 and run_grad --precision fast) on the CPU, where the
K7 wrapper takes its plain version; against the JAX package where both
start from the same float32 values.

Tolerances (tests/test_render_grad.py:163-212): fused against the unfused
culled autograd, loss rtol 1e-6, fits rtol 1e-5 / atol 1e-7, gradients
divided by their largest magnitude atol 2e-6; splats culled dead (alpha <=
eps) get exactly zero gradient. The kernels' screen-space gradients on the
same eps-culled, corner-culled lists against JAX's _make_screen_lossgrad:
num rtol 1e-5 and scaled gradients atol 2e-6, as
tests/test_torch_render_grad.py holds the exact tiers. Under the corner
cull the lists depend on the tile, so the port takes JAX's tile height
there: the entry points fused_value_and_grad and render_diff against JAX's
at its default tile (loss rtol 1e-5, fits rtol 1e-5 / atol 1e-7, scaled
gradients atol 2e-6), and the tile each entry point bins on against the
one JAX's picks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import codec as jcodec
from ggs_tpu.ops import fitness as jfitness
from ggs_tpu.ops import render_grad as jrg
from ggs_tpu.ops import render_pallas as jrp
from ggs_tpu_torch import run_ga, run_grad
from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig
from ggs_tpu_torch.models import ga as tga
from ggs_tpu_torch.models import gradient as tgradient
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import fitness as tfitness
from ggs_tpu_torch.ops import objective as tobjective
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.ops import render_grad as trg
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 48, 160
EPS = 8e-2
TGT, WM = image(31, H, W), weights(32, H, W)
OBJ = tobjective.Objective(H=H, W=W, precision="fast", cull_eps=EPS)  # corner cull on


def _genomes(seed, B=2, N=24):
    """Two splats per image below the cull (a = 5/255 <= eps)."""
    g = axes_genomes(seed, B, N, H, W)
    g[:, :2, 8] = 5.0
    return g


@pytest.mark.parametrize("mode", ["plain", "weighted", "boost"])
def test_culled_fused_matches_unfused_culled(mode):
    """tests/test_render_grad.py:171-212 on the port: the fused path (K7
    over the eps- and corner-culled lists) equals autograd through the
    unfused culled loss (K2 + K6 over the same lists); the cull engaged;
    dead splats get exactly zero gradient, live ones some."""
    g = torch.from_numpy(_genomes(40))
    tgt = torch.from_numpy(TGT)
    wm = None if mode == "plain" else torch.from_numpy(WM)
    obj = OBJ._replace(boost_only=mode == "boost", boost_beta=0.8)
    gnm = GenomeConfig(n_splats=24)
    gt = g.clone().requires_grad_(True)
    l0, f0 = tgradient.make_loss_fn(obj, gnm)(gt, tgt, wm)
    (g0,) = torch.autograd.grad(l0, gt)
    (l1, f1), g1 = tgradient.make_value_and_grad(obj, gnm)(g, tgt, wm)
    np.testing.assert_allclose(float(l1), float(l0.detach()), rtol=1e-6)
    np.testing.assert_allclose(f1.numpy(), f0.detach().numpy(), rtol=1e-5, atol=1e-7)
    scale = float(g0.abs().max()) + 1e-12
    np.testing.assert_allclose(g1.numpy() / scale, g0.numpy() / scale, atol=2e-6)
    (le, _), _ = tgradient.make_value_and_grad(obj._replace(precision="highest"), gnm)(g, tgt, wm)
    assert float(l1) != float(le)
    np.testing.assert_array_equal(g1[:, :2].numpy(), np.zeros((2, 2, 9), np.float32))
    assert float(g1[:, 2:].abs().max()) > 0.0


def _screen(g):
    """JAX's eps-tight screen-space parameters of the axes genome g."""
    g9 = jcodec.genome_to_renderer(jnp.asarray(g))
    return jrp._tighten_boxes(jcodec.preprocess(g9, H, W, 3.0), 3.0, EPS)


def test_culled_kernel_grads_match_jax():
    """K7's plain version on the eps- and corner-culled lists against JAX's
    fused kernel (_make_screen_lossgrad with corner_eps, interpret mode) on
    the same screen-space parameters, cotangent scale 2, both on the list
    tile the port's geometry takes under the corner cull (JAX's own,
    64x128 here: the corner cull is decided per tile)."""
    g = _genomes(41)
    B, N = g.shape[:2]
    geom = trg._geometry(H, W, N, None, (1.0, 1.0, 1.0), EPS, True)
    th, tw = geom[2:4]
    assert (th, tw) == (64, 128)
    pj = _screen(g)
    w_eff, _ = jfitness.weff_denom(jnp.asarray(WM), False, 1.0, H, W)
    run = jrg._make_screen_lossgrad(B, N, H, W, th, tw, N, (1.0, 1.0, 1.0), True, corner_eps=EPS)
    arrs = tuple(pj[:9]) + tuple(x.astype(jnp.float32) for x in pj[9:])
    num_j, grads_j = (np.asarray(x) for x in run(arrs, jnp.asarray(TGT), w_eff, 2.0))

    p = tcodec.SplatScreen(*(torch.from_numpy(np.array(x)) for x in pj))
    idx, cnt = trg._bin(p, geom)
    _, cnt_box = rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, geom[0], geom[1], th, tw, N)
    assert int(cnt.sum()) < int(cnt_box.sum())  # the corner cull engaged
    tgt_p, w_p = rc.pad_planes(torch.from_numpy(TGT), torch.from_numpy(WM), geom[1] * th,
                               geom[0] * tw)
    num, grads = trg.lossgrad_tiles(cnt, idx, trg._splat_feats(p), tgt_p, w_p, geom[0], th, tw,
                                    (1.0, 1.0, 1.0), 2.0)
    np.testing.assert_allclose(num.sum(1).numpy(), num_j, rtol=1e-5)
    scale = float(np.abs(grads_j).max()) + 1e-12
    np.testing.assert_allclose(grads.numpy() / scale, grads_j / scale, atol=2e-6)
    np.testing.assert_array_equal(grads[:, :, :2].numpy(), np.zeros((B, 9, 2), np.float32))


@pytest.mark.parametrize("entry", ["fused", "render_diff"])
def test_corner_culled_entry_points_match_jax(entry):
    """fused_value_and_grad and render_diff with cull_eps and the corner cull
    against JAX's fused_value_and_grad and render_pallas_diff (interpret
    mode) at JAX's default tile_h, on the same genomes: the fused path from
    the axes genome, the unfused one from the renderer genome (JAX's codec),
    each with the mean weighted fitness as its loss. Loss rtol 1e-5, fits
    rtol 1e-5 / atol 1e-7, gradients divided by their largest magnitude
    atol 2e-6 (tests/test_render_grad.py:163-167)."""
    g = _genomes(43)
    tgt, wm = torch.from_numpy(TGT), torch.from_numpy(WM)
    cull = dict(cull_eps=EPS, corner_cull=True)
    if entry == "fused":
        (loss_j, fits_j), grads_j = jrg.fused_value_and_grad(
            jnp.asarray(g), jnp.asarray(TGT), jnp.asarray(WM), H, W, interpret=True, **cull)
        (loss, fits), grads = trg.fused_value_and_grad(torch.from_numpy(g), tgt, wm, H, W, **cull)
    else:
        g9 = np.array(jcodec.genome_to_renderer(jnp.asarray(g)))

        def jax_loss(x):
            img = jrg.render_pallas_diff(x, H, W, interpret=True, **cull)
            fits = jfitness.fitness_from_images(img, jnp.asarray(TGT), jnp.asarray(WM))
            return jnp.mean(fits), fits

        (loss_j, fits_j), grads_j = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(g9))
        gt = torch.from_numpy(g9).requires_grad_(True)
        fits = tfitness.fitness_from_images(trg.render_diff(gt, H, W, **cull), tgt, wm)
        loss = torch.mean(fits)
        (grads,) = torch.autograd.grad(loss, gt)
        loss, fits = loss.detach(), fits.detach()
    grads_j = np.asarray(grads_j)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(fits.numpy(), np.asarray(fits_j), rtol=1e-5, atol=1e-7)
    scale = float(np.abs(grads_j).max()) + 1e-12
    np.testing.assert_allclose(grads.numpy() / scale, grads_j / scale, atol=2e-6)


class _Stop(Exception):
    """Raised where a tile height has been read, to skip the walk."""


@pytest.mark.parametrize("entry", ["fused", "render_diff"])
@pytest.mark.parametrize("N", [24, 2000, 10_000])
def test_corner_cull_list_tile_is_jax(monkeypatch, entry, N):
    """Under the corner cull each entry point bins on the tile height JAX's
    picks by its VMEM rule (render_grad.py:670-678, :766-780): JAX's read
    where it builds its kernel, the port's where it bins (the first pass of
    render_diff, from the whole cap). Above 8000 splats the fused path is
    refused by both packages."""
    g = axes_genomes(44, 1, N, H, W)
    seen = {}

    def record(key, tile_h):
        seen[key] = tile_h
        raise _Stop

    monkeypatch.setattr(trg, "_bin", lambda p, geom: record("port", geom[2]))
    factory = "_make_screen_lossgrad" if entry == "fused" else "_make_screen_render"
    monkeypatch.setattr(jrg, factory, lambda *a, **kw: record("jax", a[4]))
    cull = dict(cull_eps=EPS, corner_cull=True)
    if entry == "fused":
        if N > rc.MAX_SPLATS:
            with pytest.raises(ValueError):
                jrg.fused_value_and_grad(jnp.asarray(g), jnp.asarray(TGT), None, H, W, **cull)
            with pytest.raises(ValueError):
                trg.fused_value_and_grad(torch.from_numpy(g), torch.from_numpy(TGT), None, H, W,
                                         **cull)
            return
        with pytest.raises(_Stop):
            jrg.fused_value_and_grad(jnp.asarray(g), jnp.asarray(TGT), None, H, W, **cull)
        with pytest.raises(_Stop):
            trg.fused_value_and_grad(torch.from_numpy(g), torch.from_numpy(TGT), None, H, W,
                                     **cull)
    else:
        g9 = np.array(jcodec.genome_to_renderer(jnp.asarray(g)))
        with pytest.raises(_Stop):
            jrg.render_pallas_diff(jnp.asarray(g9), H, W, **cull)
        with pytest.raises(_Stop):
            trg.render_diff(torch.from_numpy(g9), H, W, **cull)
    assert seen["port"] == seen["jax"] == trg.list_tile_h(N)
    assert seen["port"] == {24: 64, 2000: 64, 10_000: 16}[N]


def test_fast_objective_in_the_gradient_paths():
    """_grad_cull_eps/_grad_corner resolve as the JAX package's; "bf16"
    gradients are refused; Adam on the culled energy descends, and
    refine_elites scores with the fast evaluator and never worsens."""
    assert tgradient._grad_cull_eps(OBJ) == EPS and tgradient._grad_corner(OBJ)
    assert tgradient._grad_cull_eps(OBJ._replace(cull_eps=None)) == rc.DEFAULT_CULL_EPS
    for obj in (OBJ._replace(precision="exact-tight"), OBJ._replace(precision="highest")):
        assert tgradient._grad_cull_eps(obj) is None and not tgradient._grad_corner(obj)
    assert not tgradient._grad_corner(OBJ._replace(corner_cull=False))
    with pytest.raises(NotImplementedError):
        tgradient.make_fit_step(OBJ._replace(precision="bf16"), GenomeConfig(), GradConfig())
    gnm = GenomeConfig(n_splats=24)
    tgt, wm = torch.from_numpy(TGT), torch.from_numpy(WM)
    make_opt, step = tgradient.make_fit_step(OBJ, gnm, GradConfig(lr=2e-2))
    g0 = torch.from_numpy(axes_genomes(42, 2, 24, H, W))
    _, fits = tgradient.run_block(tgradient.init_state(make_opt, g0), step, tgt, wm, 12)
    assert float(fits[-1].mean()) < float(fits[0].mean())
    fits0 = tobjective.evaluate(OBJ, g0, tgt, wm, device="cpu")
    el, f = tgradient.refine_elites(g0, fits0, tgt, wm, OBJ, gnm, GradConfig(lr=1e-2), steps=5)
    assert np.all(f.numpy() <= fits0.numpy())
    np.testing.assert_allclose(
        f.numpy(), tobjective.evaluate(OBJ, el, tgt, wm, device="cpu").numpy(), rtol=1e-6
    )


def test_memetic_block_under_fast():
    """The memetic block with the fast objective: the refinement walks the
    culled lists (K7's plain version here) and the best stays monotone and
    is the fast evaluator's number."""
    tgt, wm = torch.from_numpy(TGT), torch.from_numpy(WM)
    cfg = GAConfig(pop_size=6, generations=20, elite_k=2, cxpb=0.2, mutpb=0.2)
    gnm = GenomeConfig(n_splats=16, min_scale=1.0, max_scale=0.3)
    st = tga.init(torch.Generator().manual_seed(7), OBJ, tgt, wm, cfg, gnm)
    st, m = tga.run_memetic_block(st, OBJ, tgt, wm, cfg, gnm, GradConfig(lr=1e-2),
                                  refine_every=2, refine_steps=2, num_gens=4)
    assert np.all(np.diff(m[:, 0].numpy()) <= 1e-9)
    want = tobjective.evaluate(OBJ, st.best[None], tgt, wm, device="cpu")[0]
    np.testing.assert_allclose(float(st.best_fit), float(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize(
    "extra",
    [
        ["--precision", "fast"],
        ["--precision", "fast", "--cull-eps", "8e-2", "--memetic-every", "2",
         "--memetic-steps", "2"],
        ["--precision", "bf16"],
    ],
)
def test_run_ga_fast_tiers_on_cpu(extra, tmp_path):
    """run_ga at a tiny size under the fast tiers: the best falls, and the
    reported number is the winner's exact ("highest") energy."""
    out = run_ga.main([
        "--image", "synthetic:40x200", "--work-max-side", "200", "--n-splats", "16",
        "--pop-size", "4", "--elite-k", "2", "--generations", "6", "--log-every", "3",
        "--no-video", "--device", "cpu", "--output-dir", str(tmp_path), *extra,
    ])
    best = out["curves"]["best"]
    assert len(best) == 7 and best[-1] <= best[0]
    from ggs_tpu_torch.config import MaskConfig
    from ggs_tpu_torch.ops import mask
    from ggs_tpu_torch.utils import io

    t = io.ensure_hw(io.load_image("synthetic:40x200"), 40, 200, device="cpu")
    wm = mask.mask_from_config(t, 40, 200, MaskConfig())
    want = tobjective.evaluate(tobjective.Objective(H=40, W=200), out["best"][None], t, wm,
                               device="cpu")[0]
    np.testing.assert_allclose(out["best_fit"], float(want), rtol=1e-6)
    assert out["final"].shape == (40, 200, 3)


def test_run_grad_fast_on_cpu(tmp_path):
    """run_grad --precision fast --cull-eps at a tiny size: the loss falls
    and the final loss is the "highest" energy."""
    out = run_grad.main([
        "--image", "synthetic:40x200", "--work-max-side", "200", "--n-splats", "16",
        "--steps", "6", "--log-every", "3", "--precision", "fast", "--cull-eps", "1e-2",
        "--device", "cpu", "--output-dir", str(tmp_path),
    ])
    assert len(out["curve"]) == 6 and out["curve"][-1] < out["curve"][0]
    assert np.isfinite(out["best_loss"]) and out["best_loss"] > 0
