"""Port SSIM and the mix metric (ggs_tpu_torch/ops/ssim.py, the metric
branches of ops/objective.py and models/gradient.py) against
ggs_tpu/ops/ssim.py and the JAX package's objective and losses on the CPU.

The port filters with two 11-tap passes of shifted sums in float32 (rows,
then columns); JAX runs a 2-D conv at HIGHEST. Measured gap on these
inputs: the window's outer product within 1.9e-9 of JAX's (under 1 ulp);
mean SSIM within 2.4e-7 absolute, except 4.2e-6 on a constant image, where
E[xy] - mu_x mu_y is f32 rounding noise set against c2 = 9e-4 (there JAX is
6.3e-6 from the float64 value, the port 2.1e-6); ssim/mix energies of
renders within 1.6e-6 relative; the axes-genome gradients of both metrics
within atol 6.4e-8 at rtol 2e-4 (32x160, N=24, four seeds). Held to the JAX
suite's own tolerances: SSIM atol 1e-5 (tests/test_ssim.py's identity),
energies rtol 5e-5 (tests/test_render_pallas.py:140), gradients rtol 1e-4,
atol 1e-6 (tests/test_gradient.py:179). The JAX side scores on
impl="xla"; the port's gradients come from its oracle autograd and from
render_diff's plain route (impl "cuda" on CPU tensors)."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.config import GenomeConfig as JGenomeConfig
from ggs_tpu.models import gradient as jgradient
from ggs_tpu.ops import objective as jobjective
from ggs_tpu.ops import ssim as jssim
from ggs_tpu_torch.config import GenomeConfig
from ggs_tpu_torch.models import gradient as tgradient
from ggs_tpu_torch.ops import objective as tobjective
from ggs_tpu_torch.ops import ssim as tssim
from torch_inputs import axes_genomes, image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 160
SSIM_ATOL = 1e-5
ENERGY_RTOL = 5e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _images(seed):
    """[5, H, W, 3]: near the target, unrelated, near-constant (the variance
    clamp), exactly constant, and the target itself; and the target."""
    rng = np.random.default_rng(seed)
    t = image(seed, H, W)
    imgs = np.empty((5, H, W, 3), np.float32)
    imgs[0] = np.clip(t + 0.05 * rng.standard_normal(t.shape), 0.0, 1.0)
    imgs[1] = rng.uniform(0.0, 1.0, t.shape)
    imgs[2] = 0.5 + 1e-4 * rng.standard_normal(t.shape)
    imgs[3] = 0.7
    imgs[4] = t
    return imgs, t


def test_gaussian_window_matches():
    g = np.array(tssim._gaussian_window(), np.float64)
    np.testing.assert_allclose(np.outer(g, g), np.asarray(jssim._gaussian_window()), rtol=0,
                               atol=5e-9)
    assert abs(g.sum() - 1.0) < 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_dssim_and_mix_match_jax(seed):
    imgs, t = _images(seed)
    ji, jt = jnp.asarray(imgs), jnp.asarray(t)
    ti, tt = torch.from_numpy(imgs), torch.from_numpy(t)
    s = tssim.ssim(ti, tt).numpy()
    np.testing.assert_allclose(s, np.asarray(jssim.ssim(ji, jt)), rtol=0, atol=SSIM_ATOL)
    np.testing.assert_allclose(tssim.dssim(ti, tt).numpy(), np.asarray(jssim.dssim(ji, jt)),
                               rtol=0, atol=SSIM_ATOL)
    # the identity, and every mean SSIM inside [-1, 1]
    np.testing.assert_allclose(s[4], 1.0, atol=1e-5)
    assert np.all(np.abs(s) <= 1.0 + 1e-6)
    wm = weights(seed, H, W)
    for mask, boost in ((None, False), (wm, False), (wm, True)):
        for w in (0.0, 0.3, 1.0):
            got = tssim.mixed_energy(ti, tt, None if mask is None else torch.from_numpy(mask),
                                     ssim_weight=w, boost_only=boost).numpy()
            want = jssim.mixed_energy(ji, jt, None if mask is None else jnp.asarray(mask),
                                      ssim_weight=w, boost_only=boost)
            np.testing.assert_allclose(got, np.asarray(want), rtol=ENERGY_RTOL, atol=1e-7)


def test_variance_clamp_on_near_constant_images():
    """On a near-constant pair E[x^2] - mu^2 cancels to a few ulps of
    either sign; the clamp keeps every variance >= 0, so the denominator
    stays >= c1 * c2 and the map near 1 (a few ulps above it, as JAX's)."""
    rng = np.random.default_rng(5)
    base = (0.5 + 1e-5 * rng.standard_normal((2, H, W, 3))).astype(np.float32)
    imgs, t = torch.from_numpy(base[:1]), torch.from_numpy(base[1])
    taps = tssim._gaussian_window()
    mu = tssim._filter2(imgs, taps)
    raw = tssim._filter2(imgs * imgs, taps) - mu * mu
    assert float(raw.min()) < 0.0, "the cancellation should cross zero here"
    m = tssim._ssim_map(imgs, t[None], taps, 1.0)
    assert bool(torch.isfinite(m).all()) and float((m - 1.0).abs().max()) < 1e-3
    want = jssim.ssim(jnp.asarray(base[:1]), jnp.asarray(base[1]))
    np.testing.assert_allclose(tssim.ssim(imgs, t).numpy(), np.asarray(want), atol=SSIM_ATOL)


def test_ssim_bits_ignore_tf32_flags():
    """No cuDNN or cuBLAS routine, so the TF32 flags change nothing: the same
    bits with both flags on and off (the card's check is chip_smoke.py's)."""
    imgs, t = _images(3)
    ti, tt = torch.from_numpy(imgs), torch.from_numpy(t)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    out = []
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            torch.backends.cuda.matmul.allow_tf32 = flag
            out.append(tssim.ssim(ti, tt).numpy())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_array_equal(out[0], out[1])


# Calls that PyTorch may run through cuDNN or cuBLAS, where the TF32 flags
# lower float32 to a 10-bit mantissa. A line that makes one must carry
# "# f32-ok: <reason>" naming its float32 path.
_REDUCED_PRECISION_CALLS = re.compile(
    r"\b(?:F|functional|torch|nn)\.(?:conv\w*|linear|bilinear|matmul|mm|bmm|addmm|baddbmm|"
    r"einsum|tensordot|Conv\w*|Linear)\s*\(|\.(?:matmul|mm|bmm)\s*\(|\bconv[123]d\s*\("
)


def test_port_has_no_reduced_precision_call():
    """The port-side precision lint (tools/lint_precision.py is the JAX
    package's): no convolution or matmul call in ggs_tpu_torch/ without an
    explicit float32 path."""
    hits, scanned = [], 0
    for root, _, files in os.walk(os.path.join(REPO, "ggs_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            scanned += 1
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                for no, line in enumerate(f, 1):
                    code = line.split("#", 1)[0]
                    if _REDUCED_PRECISION_CALLS.search(code) and "f32-ok:" not in line:
                        hits.append(f"{os.path.relpath(path, REPO)}:{no}: {line.strip()}")
    assert scanned >= 20
    assert not hits, "calls with a TF32 path:\n" + "\n".join(hits)
    # the pattern does catch such calls
    for bad in ("y = F.conv2d(x, w)", "torch.nn.functional.conv1d(a, b)", "z = a.matmul(b)",
                "torch.einsum('ij,jk', a, b)"):
        assert _REDUCED_PRECISION_CALLS.search(bad), bad


@pytest.mark.parametrize("metric", ["ssim", "mix"])
@pytest.mark.parametrize("precision", ["exact-tight", "highest"])
def test_evaluate_metric_matches_jax(metric, precision):
    g = axes_genomes(31, 3, 24, H, W)
    tgt, wm = image(32, H, W), weights(33, H, W)
    jobj = jobjective.Objective(H=H, W=W, impl="xla", metric=metric, ssim_weight=0.3,
                                precision=precision)
    want = np.asarray(jobjective.evaluate(jobj, jnp.asarray(g), jnp.asarray(tgt), jnp.asarray(wm)))
    tobj = tobjective.Objective(H=H, W=W, metric=metric, ssim_weight=0.3, precision=precision)
    for impl in ("cuda", "oracle"):
        got = tobjective.evaluate(tobj._replace(impl=impl), g, tgt, wm, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=ENERGY_RTOL)
    # "mix" is the weighted sum of the MSE and DSSIM energies
    if metric == "mix":
        parts = [tobjective.evaluate(tobj._replace(metric=m), g, tgt, wm, device="cpu").numpy()
                 for m in ("mse", "ssim")]
        np.testing.assert_allclose(got, 0.7 * parts[0] + 0.3 * parts[1], rtol=1e-5)
    with pytest.raises(ValueError):
        tobjective.evaluate(tobj._replace(metric="psnr"), g, tgt, wm, device="cpu")


@pytest.mark.parametrize("metric", ["ssim", "mix"])
def test_value_and_grad_metric_matches_jax(metric):
    """make_value_and_grad under "ssim"/"mix" against jax.value_and_grad of
    JAX's make_loss_fn: the port's oracle autograd and render_diff's plain
    route (never the fused path, whose loss head is the weighted SSE)."""
    N = 24
    g = axes_genomes(41, 2, N, H, W)
    tgt, wm = image(42, H, W), weights(43, H, W)
    jobj = jobjective.Objective(H=H, W=W, impl="xla", metric=metric, precision="exact-tight")
    loss = jgradient.make_loss_fn(jobj, JGenomeConfig(n_splats=N))
    (jl, jf), jg = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(g), jnp.asarray(tgt), jnp.asarray(wm))
    tobj = tobjective.Objective(H=H, W=W, metric=metric, precision="exact-tight")
    for impl in ("cuda", "oracle"):
        vg = tgradient.make_value_and_grad(tobj._replace(impl=impl), GenomeConfig(n_splats=N))
        (tl, tf), tg = vg(torch.from_numpy(g), torch.from_numpy(tgt), torch.from_numpy(wm))
        np.testing.assert_allclose(float(tl), float(jl), rtol=ENERGY_RTOL)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=ENERGY_RTOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)
