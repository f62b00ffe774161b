"""Port scale-space annealing (ggs_tpu_torch/ops/anneal.py, the annealed GA
step and the annealed Adam step) against ggs_tpu/ops/anneal.py and the JAX
package's steps on the CPU, and the invariants tests/test_anneal.py pins, on
the port's own inputs.

`blur_genome_axes` goes through exp and log, whose CPU implementations in
XLA and PyTorch differ by 1-2 ulp; its value and gradient are held to 16
float32 ulp times each output's condition number, computed in float64 (the
codec's rule, tests/test_torch_codec.py). `blur_image` is two passes of
float32 shifted sums in tap order against JAX's 2-D conv at HIGHEST, which
sums its 2r+1 taps in another order: measured within 4.8e-7 of it on these
inputs and 7.2e-7 at 512x512, sigma 8 (about 12 ulp of a 0.5 value), held
to atol 1e-6. The annealed steps run on the JAX package's own replayed
draws (tests/test_torch_ga.py) and carried Adam state, JAX on impl="xla",
with the tolerances of the unannealed steps' tests; the chained gradient of
the annealed Adam step, each field over its largest value, within 1e-5:
measured up to 5.4e-6 over four seeds, the codecs' ulps amplified through
the blur (ROADMAP.md §3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.config import GAConfig as JGAConfig
from ggs_tpu.config import GenomeConfig as JGenomeConfig
from ggs_tpu.config import GradConfig as JGradConfig
from ggs_tpu.models import ga as jga
from ggs_tpu.models import gradient as jgradient
from ggs_tpu.ops import anneal as janneal
from ggs_tpu.ops import objective as jobjective
from ggs_tpu_torch import convert
from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig, MutSigma
from ggs_tpu_torch.models import ga as tga
from ggs_tpu_torch.models import gradient as tgradient
from ggs_tpu_torch.ops import anneal as tanneal
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import objective as tobjective
from ggs_tpu_torch.ops import oracle as toracle
from test_torch_ga import jax_offspring_draws
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 32, 160
ULP = 2.0**-24
BLUR_ATOL = 1e-6
SIG_MAX = MutSigma.max_defaults().__dict__
SIG_MIN = MutSigma.min_defaults().__dict__


@pytest.mark.parametrize("sigma", [0.0, 0.6, 3.0, 12.0])
def test_blur_genome_axes_value_and_gradient_match_jax(sigma):
    g = axes_genomes(40, 3, 24, H, W, max_scale=1.0)
    g[0, :4, 2:4] = np.log(0.05)  # splats far below sigma: their mass all but vanishes
    ct = np.random.default_rng(41).standard_normal(g.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: janneal.blur_genome_axes(x, sigma), jnp.asarray(g))
    (ref_grad,) = vjp(jnp.asarray(ct))
    ref, ref_grad = np.asarray(ref, np.float64), np.asarray(ref_grad, np.float64)

    gt = torch.from_numpy(g).requires_grad_(True)
    out = tanneal.blur_genome_axes(gt, sigma)
    (grad,) = torch.autograd.grad(out, gt, torch.from_numpy(ct))
    out, grad = out.detach().numpy().astype(np.float64), grad.numpy().astype(np.float64)

    copied = [0, 1, 4, 5, 6, 7]
    np.testing.assert_array_equal(out[..., copied], ref[..., copied])
    np.testing.assert_array_equal(grad[..., copied], ref_grad[..., copied])
    # condition numbers, float64: a_log' = log(v + s^2)/2 and alpha' = alpha *
    # sqrt(ra * rb), ra = vx / (vx + s^2); their gradients ra * ct_a +
    # alpha' (1 - ra) ct_alpha and sqrt(ra * rb) ct_alpha, where autograd
    # forms 1 - ra as the difference of two terms of size 1 (the quotient
    # rule), so the second term's magnitude before it cancels is alpha' (1 + ra)
    g64, s2 = g.astype(np.float64), sigma * sigma
    vx, vy = np.exp(2 * g64[..., 2]), np.exp(2 * g64[..., 3])
    ra, rb = vx / (vx + s2), vy / (vy + s2)
    amp = np.sqrt(ra * rb)
    alpha_out = g64[..., 8] * amp
    kappa = {2: np.abs(ref[..., 2]) + 1.0, 3: np.abs(ref[..., 3]) + 1.0, 8: np.abs(ref[..., 8])}
    kappa_grad = {
        2: np.abs(ra * ct[..., 2]) + np.abs(alpha_out * (1 + ra) * ct[..., 8]),
        3: np.abs(rb * ct[..., 3]) + np.abs(alpha_out * (1 + rb) * ct[..., 8]),
        8: np.abs(amp * ct[..., 8]),
    }
    for col in (2, 3, 8):
        gap = np.abs(out[..., col] - ref[..., col])
        assert np.all(gap <= 16 * ULP * kappa[col]), (col, float((gap / (ULP * kappa[col])).max()))
        gap = np.abs(grad[..., col] - ref_grad[..., col])
        assert np.all(gap <= 16 * ULP * kappa_grad[col]), (
            col, float((gap / (ULP * kappa_grad[col])).max()))
    if sigma == 0.0:
        np.testing.assert_array_equal(out[..., 8], g[..., 8])


@pytest.mark.parametrize("shape,sigma,radius", [
    ((32, 48), 2.0, 6),
    ((20, 30), 5.0, 24),  # the radius reaches past the canvas on both axes
])
def test_blur_image_matches_jax_whatever_the_tf32_flags(shape, sigma, radius):
    img = image(42, *shape)
    ref = np.asarray(janneal.blur_image(jnp.asarray(img), sigma, radius))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    outs = []
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            outs.append(tanneal.blur_image(torch.from_numpy(img), sigma, radius))
            outs.append(tanneal.blur_image(torch.from_numpy(img), torch.tensor(sigma), radius))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    np.testing.assert_allclose(outs[0].numpy(), ref, atol=BLUR_ATOL, rtol=0)
    taps = tanneal.gaussian_kernel(sigma, radius).numpy()
    np.testing.assert_allclose(taps, np.asarray(janneal.gaussian_kernel(sigma, radius)),
                               rtol=2e-7, atol=1e-12)


def test_sigma_schedule_and_radius_equal_jax():
    for total in (1, 7, 100, 1000, 500_000):
        for s0 in (0.0, 0.2, 1.0, 8.0, 33.3):
            for frac in (0.0, 0.3, 0.6, 1.0):
                for gen in sorted({0, 1, total // 7, total // 3, total // 2, total - 1, total}):
                    assert (tanneal.sigma_schedule(gen, total, s0, frac)
                            == janneal.sigma_schedule(gen, total, s0, frac))
    assert tanneal.SIGMA_SNAP == janneal.SIGMA_SNAP
    for s0 in (0.0, 0.1, 0.34, 1.0, 8.0, 12.7):
        assert tanneal.default_radius(s0) == janneal.default_radius(s0)


def test_annealed_ga_step_matches_jax_on_replayed_draws():
    """Two annealed generations: offspring scored at scale sigma against
    the same blurred target, the population evolving unblurred."""
    P, N, sigma = 8, 12, 2.5
    jcfg = JGAConfig(pop_size=P, generations=20, elite_k=2, cxpb=0.5, mutpb=0.2)
    tcfg = GAConfig(pop_size=P, generations=20, elite_k=2, cxpb=0.5, mutpb=0.2)
    jgnm = JGenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
    tgnm = GenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
    jobj = jobjective.Objective(H=H, W=W, impl="xla", precision="exact-tight")
    tobj = tobjective.Objective(H=H, W=W, precision="exact-tight")
    tgt = np.array(janneal.blur_image(jnp.asarray(image(44, H, W)), sigma, 8))
    wm = weights(45, H, W)
    tgt_t, wm_t = torch.from_numpy(tgt), torch.from_numpy(wm)

    js = jga.init(jax.random.PRNGKey(6), jobj, jnp.asarray(tgt), jnp.asarray(wm), jcfg, jgnm)
    ts = convert.ga_state_from_jax([np.array(x) for x in jax.tree.flatten(js)[0]], device="cpu")
    for _ in range(2):
        _, k_off = jax.random.split(js.key)
        draws = jax_offspring_draws(k_off, P, N, jcfg.tour_k)
        # eager, as test_torch_ga.py: JAX's jitted step rounds the mutation a
        # few ulps apart from its eager one (ROADMAP.md §3)
        js, jm = jga.step(js, jobj, jnp.asarray(tgt), jnp.asarray(wm), jcfg, jgnm, SIG_MAX,
                          SIG_MIN, blur_sigma=jnp.float32(sigma))
        ts, tm = tga.step(ts, tobj, tgt_t, wm_t, tcfg, tgnm, SIG_MAX, SIG_MIN, draws=draws,
                          blur_sigma=torch.tensor(sigma))
        np.testing.assert_allclose(ts.pop.numpy(), np.asarray(js.pop), atol=1e-6)
        np.testing.assert_allclose(ts.fits.numpy(), np.asarray(js.fits), rtol=5e-5)
        np.testing.assert_allclose(ts.best.numpy(), np.asarray(js.best), atol=1e-6)
        np.testing.assert_allclose(tm[:3].numpy(), np.asarray(jm[:3]), rtol=5e-5)
        assert int(tm[3]) == int(jm[3]) == int(ts.no_improve)
    # the offspring's fits (after the E elites) are the blurred genomes', not
    # the raw ones'
    off = ts.pop[tcfg.elite_k:]
    raw = tobjective.evaluate(tobj, off, tgt_t, wm_t, device="cpu")
    blurred = tobjective.evaluate(tobj, tanneal.blur_genome_axes(off, sigma), tgt_t, wm_t,
                                  device="cpu")
    np.testing.assert_allclose(ts.fits[tcfg.elite_k:].numpy(), blurred.numpy(), rtol=1e-6)
    assert not np.allclose(blurred.numpy(), raw.numpy(), rtol=1e-3)


@pytest.mark.parametrize("impl", ["cuda", "oracle"])
def test_annealed_adam_step_matches_jax(impl):
    """Adam steps on the blurred loss from a carried JAX state: the fits,
    the gradient chained back through the blur (the port by autograd, JAX by
    its explicit vjp) and the genomes after five steps."""
    Hc, Wc, N, B, sigma = 32, 48, 8, 2, 1.7
    g0 = axes_genomes(46, B, N, Hc, Wc, 0.3)
    tgt = np.array(janneal.blur_image(jnp.asarray(image(47, Hc, Wc)), sigma, 6))
    wm = weights(48, Hc, Wc)
    jgnm = JGenomeConfig(n_splats=N, min_scale=1.0, max_scale=0.3)
    jobj = jobjective.Objective(H=Hc, W=Wc, impl="xla", precision="exact-tight")
    opt, jstep = jgradient.make_fit_step(jobj, jgnm, JGradConfig(lr=1e-2))
    jstep = jax.jit(jstep)
    js = jgradient.init_state(opt, jnp.asarray(g0))
    js, _ = jstep(js, jnp.asarray(tgt), jnp.asarray(wm), jnp.float32(sigma))
    adam = js.opt_state[0]
    ts = convert.grad_state_from_jax(
        np.asarray(js.g), np.asarray(adam.mu), np.asarray(adam.nu), np.asarray(adam.count),
        GradConfig(lr=1e-2), device="cpu",
    )
    # JAX's chained gradient at the carried genome
    vg = jgradient.make_value_and_grad(jobj, jgnm)
    gb, blur_vjp = jax.vjp(lambda x: janneal.blur_genome_axes(x, jnp.float32(sigma)), js.g)
    (_, fj0), grads_b = vg(gb, jnp.asarray(tgt), jnp.asarray(wm))
    (gj,) = blur_vjp(grads_b)
    tobj = tobjective.Objective(H=Hc, W=Wc, impl=impl, precision="exact-tight")
    _, tstep = tgradient.make_fit_step(tobj, GenomeConfig(n_splats=N, min_scale=1.0,
                                                          max_scale=0.3), GradConfig(lr=1e-2))
    sig_t = torch.tensor(sigma)
    for i in range(5):
        js, fj = jstep(js, jnp.asarray(tgt), jnp.asarray(wm), jnp.float32(sigma))
        ts, ft = tstep(ts, torch.from_numpy(tgt), torch.from_numpy(wm), blur_sigma=sig_t)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)
        if i == 0:
            np.testing.assert_allclose(ft.numpy(), np.asarray(fj0), rtol=1e-5)
            gj = np.asarray(gj)
            scale = np.abs(gj).max(axis=(0, 1), keepdims=True)  # each of the 9 fields
            np.testing.assert_allclose(ts.g.grad.numpy() / scale, gj / scale, atol=1e-5)
    gjn = np.asarray(js.g)
    np.testing.assert_allclose(ts.g[..., :5].numpy(), gjn[..., :5], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.g[..., 5:].numpy(), gjn[..., 5:], atol=2e-5, rtol=0)


def test_blur_genome_sigma0_is_identity():
    g = torch.from_numpy(axes_genomes(49, 3, 8, H, W))
    out = tanneal.blur_genome_axes(g, 0.0)
    np.testing.assert_allclose(out.numpy(), g.numpy(), atol=1e-6)


@pytest.mark.parametrize("theta", [0.0, 0.9])
def test_blur_genome_matches_image_blur(theta):
    """One splat over a constant background is affine in its weight field, so
    rendering the blurred genome equals blurring the render, up to the
    kernel's discretization (interior only: the image blur renormalizes its
    edges; k_sigma 9 so the box truncates nothing)."""
    Hc, Wc, sigma = 96, 128, 3.0
    g = torch.tensor([[0.5, 0.5, np.log(3.0), np.log(2.0), theta, 30.0, 200.0, 90.0, 200.0]],
                     dtype=torch.float32)
    img = toracle.render_dense(tcodec.genome_to_renderer(g[None]), Hc, Wc, k_sigma=9.0)[0]
    gb = tanneal.blur_genome_axes(g, sigma)
    img_genome = toracle.render_dense(tcodec.genome_to_renderer(gb[None]), Hc, Wc, k_sigma=9.0)[0]
    img_image = tanneal.blur_image(img, sigma, radius=12)
    m = 16
    np.testing.assert_allclose(img_genome[m:-m, m:-m].numpy(), img_image[m:-m, m:-m].numpy(),
                               atol=2e-3)


def test_blur_image_keeps_dc_and_smooths():
    flat = torch.full((40, 56, 3), 0.37)
    np.testing.assert_allclose(tanneal.blur_image(flat, 5.0, radius=15).numpy(), 0.37, atol=1e-6)
    noisy = torch.rand((40, 56, 3), generator=torch.Generator().manual_seed(50))
    sm = tanneal.blur_image(noisy, 3.0, radius=9)
    assert float(sm.var()) < 0.25 * float(noisy.var())
    assert abs(float(sm.mean()) - float(noisy.mean())) < 5e-3
