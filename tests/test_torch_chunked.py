"""Chained passes above the pass size (ggs_tpu_torch/ops/render_cuda.py
_chunked_passes, the init canvas of every walk, render_grad.render_diff
with K6's d(init)) against the JAX package's chained calls, with the pass
size lowered on both sides to 7 splats (render_pallas._MAX_SMEM_SPLATS and
render_cuda.MAX_SPLATS), as tests/test_render_pallas.py:104-118 does. On
the CPU the port's wrappers take their plain versions, and the JAX side
runs its Pallas kernels in interpret mode, unrolled once where the entry
point takes `unroll` (the unroll changes no value, and a wider one costs
seconds of tracing per call).

Tolerances, with their sources (ROADMAP.md section 3):
* canvases across packages, every tier: atol 4e-6 (tests/test_torch_render.py
  and tests/test_torch_fast.py, on the exact-tier tests' input sizes);
* fitness: rtol 5e-5 (tests/test_render_pallas.py:140), the bf16 tier
  rtol 1e-5 (tests/test_torch_fast.py);
* gradients: rtol 1e-3, atol 1e-7 (tests/test_render_grad.py:40);
* the port chained against itself in one pass, exact tiers: bit for bit
  (tests/test_render_pallas.py:92-116);
* d(init) against torch autograd of the plain walk: rtol 1e-5, atol 1e-7
  (the same products taken in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import codec as jcodec
from ggs_tpu.ops import fitness as jfitness
from ggs_tpu.ops import render_grad as jrg
from ggs_tpu.ops import render_pallas as rp
from ggs_tpu_torch.config import GenomeConfig
from ggs_tpu_torch.models import gradient as tgradient
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import fitness as tfitness
from ggs_tpu_torch.ops import objective as tobjective
from ggs_tpu_torch.ops import oracle as toracle
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.ops import render_grad as trg
from torch_inputs import axes_genomes, image, weights
from torch_inputs import chained, one_torch_thread  # noqa: F401 (fixtures)

H, W, TH = 40, 200, 16
N = 20  # three passes of 6, 7 and 7 splats
CANVAS_ATOL = 4e-6
FITNESS_RTOL = {"highest": 5e-5, "exact-tight": 5e-5, "fast": 5e-5, "bf16": 1e-5}
GRAD_TOL = dict(rtol=1e-3, atol=1e-7)
TGT, WM = image(31, H, W), weights(32, H, W)
G9 = np.array(jcodec.genome_to_renderer(jnp.asarray(axes_genomes(2, 2, N, H, W))))


def _render(precision, cap=None):
    return rc.render(torch.from_numpy(G9), H, W, tile_h=TH, precision=precision, cull_eps=8e-2,
                     corner_cull=True, bin_capacity=cap).numpy()


def _fitness(precision, cap=None):
    return rc.fitness(torch.from_numpy(G9), torch.from_numpy(TGT), torch.from_numpy(WM), H, W,
                      tile_h=TH, precision=precision, cull_eps=8e-2, corner_cull=True,
                      bin_capacity=cap).numpy()


@pytest.mark.parametrize(
    "precision,cap",
    [("highest", None), ("highest", 3), ("exact-tight", None), ("fast", None), ("fast", 3),
     ("bf16", None)],
)
def test_chained_render_and_fitness_match_jax(chained, precision, cap):
    """Three chained passes in every tier against render_pallas and
    fitness_pallas; with bin_capacity=3 each pass keeps the first 3 splats
    of its own chunk, which one pass over all 20 would not."""
    kw = dict(tile_h=TH, precision=precision, cull_eps=8e-2, corner_cull=True, bin_capacity=cap,
              interpret=True, unroll=1)
    img_j = rp.render_pallas(jnp.asarray(G9), H, W, **kw)
    fit_j = rp.fitness_pallas(jnp.asarray(G9), jnp.asarray(TGT), jnp.asarray(WM), H, W, **kw)
    np.testing.assert_allclose(_render(precision, cap), np.asarray(img_j), atol=CANVAS_ATOL)
    np.testing.assert_allclose(_fitness(precision, cap), np.asarray(fit_j),
                               rtol=FITNESS_RTOL[precision])
    if cap is not None and precision == "highest":
        rc.MAX_SPLATS = 8000  # one pass: the first 3 of all 20 splats
        assert np.abs(_render(precision, cap) - np.asarray(img_j)).max() > 1e-2


@pytest.mark.parametrize("precision", ["highest", "exact-tight"])
def test_chained_equals_one_pass(chained, precision):
    """In the exact tiers the chain gives the one-pass render and fitness
    bit for bit: "over" composites in painter order, and the clamp between
    passes changes no in-gamut value."""
    img, fit = _render(precision), _fitness(precision)
    rc.MAX_SPLATS = 8000
    np.testing.assert_array_equal(img, _render(precision))
    np.testing.assert_array_equal(fit, _fitness(precision))


G9_GRAD = G9[:1, :14]  # two passes of 7: the second starts from the first's canvas


def _jax_grads(box):
    def f(g9):
        img = jrg.render_pallas_diff(g9, H, W, tile_h=TH, interpret=True, box=box)
        return jnp.mean(jfitness.fitness_from_images(img, jnp.asarray(TGT), jnp.asarray(WM))), img

    (_, img), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(G9_GRAD))
    return np.asarray(img), np.asarray(grad)


def _port_grads(box):
    gt = torch.from_numpy(G9_GRAD).requires_grad_(True)
    img = trg.render_diff(gt, H, W, box=box)
    loss = torch.mean(tfitness.fitness_from_images(img, torch.from_numpy(TGT),
                                                   torch.from_numpy(WM)))
    (grad,) = torch.autograd.grad(loss, gt)
    return img.detach().numpy(), grad.numpy()


def test_render_diff_chained_grads_match_jax(chained, monkeypatch):
    """Renderer-genome gradients through two chained RenderDiff passes
    (K2 with init forward, K6 with d(init) backward) against jax.grad
    through render_pallas_diff's chained custom VJP on the same 16x128
    tiles, and the forward canvas."""
    monkeypatch.setattr(jrg, "_FWD_UNROLL", 1)
    img_j, grad_j = _jax_grads("tight")
    img_t, grad_t = _port_grads("tight")
    np.testing.assert_allclose(img_t, img_j, atol=CANVAS_ATOL)
    assert np.all(np.isfinite(grad_t)) and np.abs(grad_t).max() > 0
    np.testing.assert_allclose(grad_t, grad_j, **GRAD_TOL)


def test_dinit_matches_autograd():
    """K6's plain version with an init canvas: d(init) = g * T_total
    against torch autograd of the plain walk from that canvas; without an
    init there is no d(init)."""
    g9 = torch.from_numpy(G9)
    p = tcodec.preprocess(g9, H, W, 3.0)
    n_tx, n_ty = -(-W // 128), -(-H // TH)
    idx, cnt = rc.bin_splats(p.x0, p.x1, p.y0, p.y1, n_tx, n_ty, TH, 128, N)
    rng = np.random.default_rng(33)
    shape = (2, 3, n_ty * TH, n_tx * 128)
    init = torch.from_numpy(rng.uniform(0.05, 0.95, shape).astype(np.float32))
    g_img = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    grads, dinit = trg.bwd_tiles(cnt, idx, trg._splat_feats(p), g_img, n_tx, TH, 128,
                                 (1.0, 1.0, 1.0), init=init)
    ir = init.clone().requires_grad_(True)
    planes = rc._walk_plain(cnt, idx, rc._splat_feats_fast(p), n_tx, TH, 128, (1.0, 1.0, 1.0),
                            init=ir)
    canvas = rc._untile(torch.stack(planes, 1), n_tx)
    (want,) = torch.autograd.grad(torch.sum(canvas * g_img), ir)
    np.testing.assert_allclose(dinit.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
    assert float(torch.abs(dinit - g_img).max()) > 0.1  # the splats' transmittance shows
    plain, none = trg.bwd_tiles_plain(cnt, idx, trg._splat_feats(p), g_img, n_tx, TH, 128,
                                      (1.0, 1.0, 1.0))
    assert none is None and plain.shape == grads.shape


def test_value_and_grad_above_the_limit_takes_autograd(chained, monkeypatch):
    """Above the pass size fused_value_and_grad refuses (as in JAX), and
    make_value_and_grad takes autograd through render_diff: K6's plain
    version once per pass, K7's never; its gradients equal torch autograd
    through the dense oracle."""
    obj = tobjective.Objective(H=H, W=W, precision="exact-tight")
    g = torch.from_numpy(axes_genomes(4, 2, N, H, W))
    tgt, wm = torch.from_numpy(TGT), torch.from_numpy(WM)
    with pytest.raises(ValueError):
        trg.fused_value_and_grad(g, tgt, wm, H, W)
    calls = []
    bwd = trg.bwd_tiles
    monkeypatch.setattr(trg, "bwd_tiles", lambda *a, **k: calls.append(1) or bwd(*a, **k))
    monkeypatch.setattr(trg, "lossgrad_tiles", None)  # K7 must not be reached
    (loss, fits), grads = tgradient.make_value_and_grad(obj, GenomeConfig(n_splats=N))(g, tgt, wm)
    assert len(calls) == 3
    gr = g.clone().requires_grad_(True)
    img = toracle.render_dense(tcodec.genome_to_renderer(gr), H, W, box="tight")
    (ref,) = torch.autograd.grad(torch.mean(tfitness.fitness_from_images(img, tgt, wm)), gr)
    np.testing.assert_allclose(grads.numpy(), ref.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(fits.numpy(), tobjective.evaluate(obj, g, tgt, wm, device="cpu"),
                               rtol=1e-5)
