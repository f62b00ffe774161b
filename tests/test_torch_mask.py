"""Port importance mask and fitness modes (ggs_tpu_torch/ops/mask.py,
fitness.py) against ggs_tpu/ops/mask.py and fitness.py on the CPU.

Mask tolerance: atol 2e-5. The mask is three 2%/98%-quantile
normalizations deep, each a division by a small spread, and ends in
m ** 0.7, whose slope grows without bound near 0; float32 differences of
a few ulp in the Sobel sums, pooling and resize (summed in another order
than XLA's convolution and resize) are amplified on their way through
(measured worst 2.2e-6 at these sizes, and 1.3e-5 for a noisy 1024^2
target reduced to 512^2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import fitness as jfit
from ggs_tpu.ops import mask as jmask
from ggs_tpu_torch.ops import fitness as tfit
from ggs_tpu_torch.ops import mask as tmask
from torch_inputs import image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

MASK_ATOL = 2e-5


@pytest.mark.parametrize(
    "src,dst,smooth,strength",
    [
        ((48, 64), (48, 64), 3, 0.7),  # same size
        ((96, 128), (48, 64), 3, 0.7),  # 2x downscale: the antialiased resize
        ((80, 100), (48, 64), 0, 1.0),  # non-integer downscale, no smoothing
    ],
)
def test_importance_mask_matches(src, dst, smooth, strength):
    tgt = image(7, *src)
    ref = jmask.compute_importance_mask(
        jnp.asarray(tgt), dst[0], dst[1], smooth=smooth, strength=strength
    )
    got = tmask.compute_importance_mask(
        torch.from_numpy(tgt), dst[0], dst[1], smooth=smooth, strength=strength
    )
    assert got.shape == dst
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=MASK_ATOL)


def test_resize_matches_jax_image_resize():
    """The resize alone, up and down, against jax.image.resize."""
    import jax

    x = image(8, 60, 90)
    for hw in [(30, 45), (24, 31), (120, 180)]:
        ref = jax.image.resize(
            jnp.asarray(x), (*hw, 3), method="bilinear", precision=jax.lax.Precision.HIGHEST
        )
        got = tmask.resize_bilinear(torch.from_numpy(x).permute(2, 0, 1), *hw).permute(1, 2, 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("mode", ["plain", "weighted", "boost"])
def test_fitness_modes_match(mode):
    rng = np.random.default_rng(9)
    imgs = rng.uniform(0.0, 1.0, (4, 24, 40, 3)).astype(np.float32)
    tgt = image(9, 24, 40)
    wm = None if mode == "plain" else weights(9, 24, 40)
    boost = mode == "boost"
    ref = jfit.fitness_from_images(
        jnp.asarray(imgs), jnp.asarray(tgt), None if wm is None else jnp.asarray(wm),
        boost_only=boost, boost_beta=0.8,
    )
    got = tfit.fitness_from_images(
        torch.from_numpy(imgs), torch.from_numpy(tgt),
        None if wm is None else torch.from_numpy(wm), boost_only=boost, boost_beta=0.8,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    # weff_denom reproduces the same fitness in every mode
    w_eff, denom = tfit.weff_denom(
        None if wm is None else torch.from_numpy(wm), boost, 0.8, 24, 40
    )
    d2 = ((torch.from_numpy(imgs) - torch.from_numpy(tgt)[None]) ** 2).sum(-1)
    num = (d2 if w_eff is None else d2 * w_eff[None]).sum((1, 2))
    np.testing.assert_allclose((num / denom).numpy(), np.asarray(ref), rtol=1e-5)
    jw, jd = jfit.weff_denom(None if wm is None else jnp.asarray(wm), boost, 0.8, 24, 40)
    np.testing.assert_allclose(float(denom), float(jd), rtol=1e-6)
