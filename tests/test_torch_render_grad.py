"""Port differentiable renderer (ggs_tpu_torch/ops/render_grad.py) against
ggs_tpu/ops/render_grad.py on the same float32 inputs, on the CPU: the port's
K6/K7 wrappers take their plain versions there, and the JAX side runs its
Pallas kernels in interpret mode, once per module (each call costs seconds).

Across packages the gradients are compared where both sides start from the
same float32 values: with respect to the renderer genome for the unfused
path (as tests/test_render_grad.py does), and with respect to the
screen-space parameters for the fused kernel (JAX's _make_screen_lossgrad).
Through genome_to_renderer the two packages' exp/cos/sin differ by 1-2 ulp,
amplified by the Cholesky factor's conditioning (ROADMAP.md section 3): on
these inputs that alone moves single axes-genome gradient components by up
to 1.1 x the fused tolerance below. The port's own chain from the axes
genome is held against torch autograd through its dense oracle instead.

Tolerances, with their sources:
* forward canvas: atol 4e-6, the port's cross-package canvas tolerance
  (tests/test_torch_render.py; XLA's and PyTorch's CPU expf differ by 1-2 ulp
  and each covering splat adds such a difference);
* gradients against JAX and against torch autograd through the dense
  oracle: rtol 1e-3, atol 1e-7 (tests/test_render_grad.py:40);
* fused against JAX's fused: loss and num rtol 1e-5, fits rtol 1e-5 / atol
  1e-7, gradients divided by their largest magnitude atol 2e-6
  (tests/test_render_grad.py:163-167, the loss loosened from 1e-6 to 1e-5
  because the two packages' canvases already differ by ulps);
* fused against the port's unfused: as tests/test_render_grad.py:163-167."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import codec as jcodec
from ggs_tpu.ops import fitness as jfitness
from ggs_tpu.ops import render_grad as jrg
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import fitness as tfitness
from ggs_tpu_torch.ops import oracle as toracle
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.ops import render_grad as trg
from ggs_tpu_torch.utils import profiling
from torch_inputs import axes_genomes, image, pass_lists, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 48, 160
CANVAS_ATOL = 4e-6
GRAD_TOL = dict(rtol=1e-3, atol=1e-7)
TGT, WM = image(21, H, W), weights(22, H, W)


def _alpha255():
    """Every splat at alpha 255, three centred exactly on a pixel (corners
    and a clip bound), where f == 1 and the 3DGS division by 1 - f fails."""
    g = axes_genomes(2, 2, 20, H, W)
    g[..., 8] = 255.0
    g[0, 0, 0:2] = 0.0
    g[0, 1, 0:2] = 1.0
    g[1, 0, 0:2] = (1.0, 0.0)
    return g


CASES = {
    "reference": (axes_genomes(0, 2, 24, H, W), "reference"),
    "tight": (axes_genomes(0, 2, 24, H, W), "tight"),
    "alpha255": (_alpha255(), "reference"),
    # huge splats: every tile lists all 70 > 2 x CHUNK, crossing chunk boundaries
    "n70": (axes_genomes(3, 1, 70, H, W, max_scale=1.0), "reference"),
}


def _g9(g):
    """The renderer genome both packages differentiate (JAX's codec)."""
    return np.array(jcodec.genome_to_renderer(jnp.asarray(g)))


@pytest.fixture(scope="module")
def jax_unfused():
    """case -> (image, loss, renderer-genome grads) of JAX's render_pallas_diff."""
    cache = {}

    def get(name):
        if name not in cache:
            g, box = CASES[name]

            def f(g9):
                img = jrg.render_pallas_diff(g9, H, W, interpret=True, box=box)
                fits = jfitness.fitness_from_images(img, jnp.asarray(TGT), jnp.asarray(WM))
                return jnp.mean(fits), img

            (loss, img), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(_g9(g)))
            cache[name] = (np.asarray(img), float(loss), np.asarray(grad))
        return cache[name]

    return get


def _port_unfused(g9, box):
    """Autograd through render_diff (forward K2, backward K6) from g9."""
    gt = torch.from_numpy(g9).requires_grad_(True)
    img = trg.render_diff(gt, H, W, box=box)
    loss = torch.mean(tfitness.fitness_from_images(img, torch.from_numpy(TGT), torch.from_numpy(WM)))
    (grad,) = torch.autograd.grad(loss, gt)
    return img.detach().numpy(), loss.item(), grad.numpy()


def _oracle_autograd(g, box, wm=WM):
    gt = torch.from_numpy(g).requires_grad_(True)
    img = toracle.render_dense(tcodec.genome_to_renderer(gt), H, W, box=box)
    fits = tfitness.fitness_from_images(
        img, torch.from_numpy(TGT), None if wm is None else torch.from_numpy(wm)
    )
    (grad,) = torch.autograd.grad(torch.mean(fits), gt)
    return grad.numpy()


@pytest.mark.parametrize("name", ["reference", "tight"])
def test_render_diff_forward_matches_jax(jax_unfused, name):
    g, box = CASES[name]
    img_j, loss_j, _ = jax_unfused(name)
    img_t, loss_t, _ = _port_unfused(_g9(g), box)
    np.testing.assert_allclose(img_t, img_j, atol=CANVAS_ATOL)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    # the forward is K2's walk: equal to the port's dense oracle bit for bit
    ref = toracle.render_dense(torch.from_numpy(_g9(g)), H, W, box=box)
    np.testing.assert_array_equal(img_t, ref.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_unfused_grads_match_jax(jax_unfused, name):
    """Renderer-genome gradients through render_diff (plain K6) against
    jax.grad through render_pallas_diff: both boxes, f == 1 at pixel
    centres, and lists longer than two replay chunks."""
    g, box = CASES[name]
    _, _, grad_j = jax_unfused(name)
    _, _, grad_t = _port_unfused(_g9(g), box)
    assert np.all(np.isfinite(grad_t))
    np.testing.assert_allclose(grad_t, grad_j, **GRAD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_port_oracle_autograd(name):
    """Unfused (K6) and fused (K7) genome gradients against torch autograd
    through oracle.render_dense, the port's in-package anchor."""
    g, box = CASES[name]
    ref = _oracle_autograd(g, box)
    gt = torch.from_numpy(g).requires_grad_(True)
    img = trg.render_diff(tcodec.genome_to_renderer(gt), H, W, box=box)
    loss = torch.mean(tfitness.fitness_from_images(img, torch.from_numpy(TGT), torch.from_numpy(WM)))
    (unfused,) = torch.autograd.grad(loss, gt)
    np.testing.assert_allclose(unfused.numpy(), ref, **GRAD_TOL)
    _, fused = trg.fused_value_and_grad(
        torch.from_numpy(g), torch.from_numpy(TGT), torch.from_numpy(WM), H, W, box=box
    )
    np.testing.assert_allclose(fused.numpy(), ref, **GRAD_TOL)


@pytest.fixture(scope="module")
def jax_fused():
    """boost -> JAX's fused_value_and_grad (loss, fits) on the axes genome,
    and its fused kernel's (num [B], screen-space grads [B, 9, N]) with
    cotangent scale 2 on the screen parameters of the same genome."""
    cache = {}

    def get(boost):
        if boost not in cache:
            g, box = CASES["tight"]
            (loss, fits), _ = jrg.fused_value_and_grad(
                jnp.asarray(g), jnp.asarray(TGT), jnp.asarray(WM), H, W,
                boost_only=boost, boost_beta=0.8, interpret=True, box=box,
            )
            w_eff, _ = jfitness.weff_denom(jnp.asarray(WM), boost, 0.8, H, W)
            p = _jax_screen(g)
            B, N = g.shape[:2]
            run = jrg._make_screen_lossgrad(B, N, H, W, 64, 128, N, (1.0, 1.0, 1.0), True)
            arrs = tuple(p[:9]) + tuple(x.astype(jnp.float32) for x in p[9:])
            num, grads = run(arrs, jnp.asarray(TGT), w_eff, 2.0)
            cache[boost] = (float(loss), np.asarray(fits), np.asarray(num), np.asarray(grads), w_eff)
        return cache[boost]

    return get


def _jax_screen(g):
    p = jcodec.preprocess(jnp.asarray(_g9(g)), H, W, 3.0)
    return jcodec.tighten_boxes_exact(p, 3.0)


@pytest.mark.parametrize("boost", [False, True])
def test_fused_matches_jax_fused(jax_fused, boost):
    """fused_value_and_grad (plain K7) against JAX's (interpret mode), with
    the importance mask, in both weighted scoring modes: loss and fits end
    to end; num and gradients of the fused kernels on the same screen-space
    parameters."""
    loss_j, fits_j, num_j, grads_j, w_eff = jax_fused(boost)
    g, box = CASES["tight"]
    (loss, fits), _ = trg.fused_value_and_grad(
        torch.from_numpy(g), torch.from_numpy(TGT), torch.from_numpy(WM), H, W,
        boost_only=boost, boost_beta=0.8, box=box,
    )
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    np.testing.assert_allclose(fits.numpy(), fits_j, rtol=1e-5, atol=1e-7)

    p = tcodec.SplatScreen(*(torch.from_numpy(np.asarray(x)) for x in _jax_screen(g)))
    th, tw = trg.GRAD_TILE_H, trg.GRAD_TILE_W
    n_tx, n_ty = -(-W // tw), -(-H // th)
    idx, cnt = rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, th, tw, g.shape[1])
    tgt_p, w_p = rc.pad_planes(
        torch.from_numpy(TGT), torch.from_numpy(np.asarray(w_eff)), n_ty * th, n_tx * tw
    )
    num, grads = trg.lossgrad_tiles(
        cnt, idx, trg._splat_feats(p), tgt_p, w_p, n_tx, th, tw, (1.0, 1.0, 1.0), 2.0
    )
    np.testing.assert_allclose(num.sum(1).numpy(), num_j, rtol=1e-5)
    scale = float(np.abs(grads_j).max()) + 1e-12
    np.testing.assert_allclose(grads.numpy() / scale, grads_j / scale, atol=2e-6)


@pytest.mark.parametrize("mode", ["plain", "weighted", "boost"])
@pytest.mark.parametrize("box", ["reference", "tight"])
def test_fused_matches_unfused(mode, box):
    """The port's fused path against autograd of its unfused loss, every
    scoring mode (fitness.weff_denom is their one home)."""
    g = torch.from_numpy(axes_genomes(4, 3, 24, H, W))
    tgt = torch.from_numpy(TGT)
    wm = None if mode == "plain" else torch.from_numpy(WM)
    boost = mode == "boost"
    gt = g.clone().requires_grad_(True)
    img = trg.render_diff(tcodec.genome_to_renderer(gt), H, W, box=box)
    f0 = tfitness.fitness_from_images(img, tgt, wm, boost_only=boost, boost_beta=0.8)
    l0 = torch.mean(f0)
    (g0,) = torch.autograd.grad(l0, gt)
    (l1, f1), g1 = trg.fused_value_and_grad(g, tgt, wm, H, W, boost_only=boost, boost_beta=0.8, box=box)
    np.testing.assert_allclose(float(l1), l0.item(), rtol=1e-6)
    np.testing.assert_allclose(f1.numpy(), f0.detach().numpy(), rtol=1e-5, atol=1e-7)
    scale = float(g0.abs().max()) + 1e-12
    np.testing.assert_allclose(g1.numpy() / scale, g0.numpy() / scale, atol=2e-6)


def test_plain_walks_agree_and_cpu_takes_plain():
    """On the same lists: K7's num partials equal K1's partials bit for bit,
    K6 fed K7's own cotangent gives K7's gradients, and on CPU tensors no
    wrapper counts a launch."""
    g9 = tcodec.genome_to_renderer(torch.from_numpy(axes_genomes(5, 2, 40, H, W)))
    th, tw = trg.GRAD_TILE_H, trg.GRAD_TILE_W
    cnt, idx, feats_fast, n_tx, n_ty = pass_lists(g9, H, W, 3.0, "exact-tight", None, th, tw)
    p = tcodec.tighten_boxes_exact(tcodec.preprocess(g9, H, W, 3.0), 3.0)
    feats = trg._splat_feats(p)
    assert feats.shape == (2, 13, 41) and bool((feats[:, :, 40] == 0).all())
    Hp, Wp = n_ty * th, n_tx * tw
    tgt_p, w_p = rc.pad_planes(torch.from_numpy(TGT), torch.from_numpy(WM), Hp, Wp)
    bg = (1.0, 1.0, 1.0)
    before = (profiling.COUNTS["K6"], profiling.COUNTS["K7"])
    num, g7 = trg.lossgrad_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, th, tw, bg, 0.5)
    k1 = rc.fitness_tiles(cnt, idx, feats_fast, tgt_p, w_p, n_tx, th, tw, bg)
    np.testing.assert_array_equal(num.numpy(), k1.numpy())
    canvas = rc.render_tiles(cnt, idx, feats_fast, n_tx, th, tw, bg)
    g_img = 0.5 * w_p * (torch.clamp(canvas, 0.0, 1.0) - tgt_p[None])
    g6, dinit = trg.bwd_tiles(cnt, idx, feats, g_img.contiguous(), n_tx, th, tw, bg)
    assert dinit is None  # no init canvas: no d(init)
    assert g6.shape == g7.shape == (2, 9, 40)
    row_scale = g7.abs().amax(dim=(0, 2), keepdim=True).numpy()  # each of the 9 fields
    np.testing.assert_allclose(g6.numpy() / row_scale, g7.numpy() / row_scale, atol=2e-6)
    assert (profiling.COUNTS["K6"], profiling.COUNTS["K7"]) == before


def test_unported_options_raise(monkeypatch):
    g9 = tcodec.genome_to_renderer(torch.from_numpy(axes_genomes(6, 1, 8, H, W)))
    # row slabs are ported (tests/test_torch_slabs.py): the top slab is the
    # full canvas's first rows, bit for bit (no shift, the same 16-row lists)
    full = trg.render_diff(g9, H, W).detach()
    for kw in ({"y_origin": 0, "out_rows": 16}, {"out_rows": 16}):
        np.testing.assert_array_equal(trg.render_diff(g9, H, W, **kw).detach().numpy(),
                                      full[:, :16].numpy())
    # the fast tier's culls are ported (tests/test_torch_fast_grad.py); the
    # corner cull runs only with cull_eps, as in the JAX package
    np.testing.assert_array_equal(
        trg.render_diff(g9, H, W, corner_cull=True).detach().numpy(),
        trg.render_diff(g9, H, W).detach().numpy(),
    )
    # passes chained through an init canvas are ported (tests/test_torch_chunked.py):
    # above the pass size render_diff chains, and equals its one pass bit for bit
    one = trg.render_diff(g9, H, W).detach()
    monkeypatch.setattr(rc, "MAX_SPLATS", 3)
    np.testing.assert_array_equal(trg.render_diff(g9, H, W).detach().numpy(), one.numpy())
    with pytest.raises(ValueError):  # the fused kernel takes one pass, as in JAX
        trg.fused_value_and_grad(torch.zeros((1, 4, 9)), torch.zeros((H, W, 3)), None, H, W)
    with pytest.raises(ValueError):
        trg.render_diff(g9, H, W, box="loose")
