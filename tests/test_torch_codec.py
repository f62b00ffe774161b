"""Port codec (ggs_tpu_torch/ops/codec.py) against ggs_tpu/ops/codec.py on
the same float32 inputs: preprocess, the tight boxes, clamping and wrapping
within rtol/atol 1e-6 and integer boxes equal; genome_to_renderer's
Cholesky columns within a stated, condition-scaled bound (see its test)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import codec as jcodec
from ggs_tpu_torch.ops import codec as tcodec
from torch_inputs import axes_genomes
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed,H,W", [(0, 40, 200), (1, 75, 131), (2, 512, 512)])
def test_genome_to_renderer_matches(seed, H, W):
    """Copied and clamped columns are equal. The Cholesky columns go through
    exp/cos/sin/log, whose CPU implementations in XLA and PyTorch differ by
    1-2 ulp; two subtractions then amplify that by their condition number
    (syy - l21^2 for log l22, sx^2 - sy^2 for l21), which reaches ~1e3 for
    elongated splats. So those columns are held to 16 float32 ulp times the
    condition number (measured worst: 8), computed in float64."""
    g = axes_genomes(seed, 3, 32, H, W, max_scale=1.0)
    ref = _np(jcodec.genome_to_renderer(jnp.asarray(g)))
    got = _np(tcodec.genome_to_renderer(torch.from_numpy(g)))
    np.testing.assert_array_equal(got[..., [0, 1, 5, 6, 7, 8]], ref[..., [0, 1, 5, 6, 7, 8]])

    g64 = g.astype(np.float64)
    sx2, sy2 = np.exp(2 * g64[..., 2]), np.exp(2 * g64[..., 3])
    c, s = np.cos(g64[..., 4]), np.sin(g64[..., 4])
    sxx, syy = sx2 * c * c + sy2 * s * s, sx2 * s * s + sy2 * c * c
    l11 = np.sqrt(sxx)
    l21 = (sx2 - sy2) * s * c / l11
    kappa = {
        2: np.abs(ref[..., 2]) + 1.0,
        3: syy / (syy - l21 * l21),
        4: (sx2 + sy2) * np.abs(s * c) / l11 + np.abs(ref[..., 4]),
    }
    ulp = 2.0**-24
    for col, k in kappa.items():
        gap = np.abs(got[..., col].astype(np.float64) - ref[..., col])
        assert np.all(gap <= 16 * ulp * k), (col, float((gap / (ulp * k)).max()))


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("seed,H,W", [(3, 40, 200), (4, 200, 328)])
def test_preprocess_and_tight_boxes_match(seed, H, W, tight):
    g = axes_genomes(seed, 2, 32, H, W, max_scale=1.0)
    # adversarial rows: tiny/huge sigma, corner centers, alpha 0 and 255
    g[0, 0, 2:4] = np.log(1e-3)
    g[0, 1, 2:4] = np.log(500.0)
    g[0, 2, 0:2] = 0.0
    g[0, 3, 0:2] = 1.0
    g[0, 4, 8] = 0.0
    g[0, 5, 8] = 255.0
    g9 = np.array(jcodec.genome_to_renderer(jnp.asarray(g)))
    pj = jcodec.preprocess(jnp.asarray(g9), H, W, 3.0)
    pt = tcodec.preprocess(torch.from_numpy(g9), H, W, 3.0)
    if tight:
        pj = jcodec.tighten_boxes_exact(pj, 3.0)
        pt = tcodec.tighten_boxes_exact(pt, 3.0)
    for name in pj._fields:
        a, b = _np(getattr(pt, name)), _np(getattr(pj, name))
        if name in ("x0", "x1", "y0", "y1"):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_clamp_and_wrap_match():
    rng = np.random.default_rng(5)
    g = rng.normal(0.0, 6.0, (4, 64, 9)).astype(np.float32)
    g[..., 5:9] *= 100.0
    ref = jcodec.clamp_genome(jnp.asarray(g), 48, 96, 3.0, 0.1)
    got = tcodec.clamp_genome(torch.from_numpy(g), 48, 96, 3.0, 0.1)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    th = np.linspace(-20.0, 20.0, 4001, dtype=np.float32)
    th = np.concatenate([th, np.float32([np.pi, -np.pi, 0.0])])
    np.testing.assert_allclose(
        _np(tcodec.wrap_angle(torch.from_numpy(th))),
        _np(jcodec.wrap_angle(jnp.asarray(th))),
        **TOL,
    )


def test_work_size_and_pixel_rescale_match():
    for hw in [(512, 512), (384, 512), (1000, 333), (7, 3000)]:
        for side in (64, 200, 512):
            assert tcodec.choose_work_size(*hw, max_side=side) == jcodec.choose_work_size(
                *hw, max_side=side
            )
    g = axes_genomes(6, 1, 16, 64, 64)[0]
    ref = jcodec.scale_genome_pixels_anisotropic(jnp.asarray(g), sH=1.5, sW=0.75)
    got = tcodec.scale_genome_pixels_anisotropic(torch.from_numpy(g), sH=1.5, sW=0.75)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_clip_gradients_match_jax():
    """Gradients at the clip bounds: torch.autograd.grad of a weighted sum of
    every float field of preprocess(genome_to_renderer(g)) equals jax.grad
    of the same expression, with genes exactly on 0, 1 and 255 and on the
    log-scale bounds of clamp_genome (where projected Adam leaves them).
    jnp.clip and jnp.maximum give half the gradient at a tie, torch.clamp
    all of it. Tolerance 1e-6 relative to the largest gradient: the
    Cholesky columns go through exp/cos/sin, 1-2 ulp apart in XLA and
    PyTorch."""
    import jax

    H, W, min_scale, max_scale = 40, 200, 3.0, 0.1
    g = axes_genomes(7, 2, 16, H, W, max_scale=max_scale)
    lo, hi = np.log(np.float32(min_scale)), np.log(np.float32(max_scale * max(H, W)))
    g[0, 0, 0:2] = 0.0
    g[0, 1, 0:2] = 1.0
    g[0, 2, 5:9] = 0.0
    g[0, 3, 5:9] = 255.0
    g[0, 4, 2:4] = lo
    g[0, 5, 2:4] = hi
    g[1, 0, [0, 5, 8]] = [1.0, 255.0, 255.0]
    g[1, 1, [1, 6, 7]] = [0.0, 0.0, 255.0]
    wts = np.random.default_rng(8).uniform(-1.0, 1.0, (9,) + g.shape[:2]).astype(np.float32)
    fields = ("cx", "cy", "sxx", "sxy", "syy", "rc", "gc", "bc", "a")

    def jf(gg):
        p = jcodec.preprocess(jcodec.genome_to_renderer(gg), H, W, 3.0)
        return sum(jnp.sum(jnp.asarray(w) * getattr(p, f)) for w, f in zip(wts, fields))

    ref = np.asarray(jax.grad(jf)(jnp.asarray(g)))
    gt = torch.from_numpy(g).requires_grad_(True)
    p = tcodec.preprocess(tcodec.genome_to_renderer(gt), H, W, 3.0)
    val = sum(torch.sum(torch.from_numpy(w) * getattr(p, f)) for w, f in zip(wts, fields))
    (got,) = torch.autograd.grad(val, gt)
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # the ties are taken: a gene on a bound gets half its interior gradient
    assert got[0, 0, 0] != 0.0 and got[0, 3, 8] != 0.0
    # forward values are the plain clamps', with and without autograd recording
    g9 = tcodec.genome_to_renderer(torch.from_numpy(g))
    np.testing.assert_array_equal(g9[..., 5:9].numpy(), np.clip(g[..., 5:9], 0.0, 255.0))
    g9_grad = tcodec.genome_to_renderer(torch.from_numpy(g).requires_grad_(True))
    np.testing.assert_array_equal(g9_grad.detach().numpy(), g9.numpy())
    p_grad = tcodec.preprocess(g9_grad, H, W, 3.0)
    for name, a in zip(p_grad._fields, tcodec.preprocess(g9, H, W, 3.0)):
        np.testing.assert_array_equal(getattr(p_grad, name).detach().numpy(), a.numpy(), err_msg=name)
