"""Scale-space annealing: continuous coarse-to-fine at a fixed canvas.

PyTorch counterpart of `ggs_tpu/ops/anneal.py` (docs/DESIGN.md §9c).
Evaluating a genome "at scale sigma" means: each splat's covariance gains
sigma^2 I (in the axes-angle encoding only the two log-scale genes move,
s -> sqrt(s^2 + sigma^2)), its alpha scales by sqrt(det Sigma / det(Sigma +
sigma^2 I)) so its rendered layer is its Gaussian-blurred self, and the
target is blurred with the same Gaussian. sigma is a 0-d tensor on the
genome's device (or a Python float), so one step serves the whole schedule
with no host sync.

`blur_image` is two separable passes of float32 shifted sums over a
zero-padded canvas, divided by the same passes over an all-ones canvas:
the JAX package's conv at Precision.HIGHEST with "SAME" padding
(anneal.py:89-111). No convolution routine, so the TF32 flags cannot reach
it (as ops/ssim.py). `sigma_schedule` is Python float arithmetic, as in
the JAX package, and returns the same floats.
"""
from __future__ import annotations

import math

import torch

from . import codec

# Below this sigma the blur is numerically a no-op on >=1px splats; the
# schedule snaps to the exact objective (sigma = 0) instead of limping there.
SIGMA_SNAP = 0.25


def _sigma(sigma, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(sigma, dtype=torch.float32, device=like.device)


def blur_genome_axes(genome: torch.Tensor, sigma, conserve_mass: bool = True) -> torch.Tensor:
    """Axes-angle genome [..., N, 9] -> the same genome at scale `sigma`.

    sx' = sqrt(sx^2 + sigma^2) per axis, theta unchanged; with conserve_mass
    alpha scales by sx*sy / sqrt((sx^2+s^2)(sy^2+s^2)), so the splat's layer
    equals the Gaussian blur of the original layer. Differentiable in the
    genome and in sigma by autograd."""
    sigma = _sigma(sigma, genome)
    s2 = sigma * sigma
    vx = torch.exp(2.0 * genome[..., codec.ALOG])  # sx^2
    vy = torch.exp(2.0 * genome[..., codec.BLOG])
    dx, dy = vx + s2, vy + s2
    a_log = 0.5 * torch.log(dx)
    b_log = 0.5 * torch.log(dy)
    alpha = genome[..., codec.ALPHA]
    if conserve_mass:
        alpha = alpha * torch.sqrt((vx / dx) * (vy / dy))
    return torch.cat(
        [
            genome[..., codec.X : codec.Y + 1],
            a_log[..., None],
            b_log[..., None],
            genome[..., codec.THETA : codec.ALPHA],
            alpha[..., None],
        ],
        dim=-1,
    )


def gaussian_kernel(sigma, radius: int, device="cpu") -> torch.Tensor:
    """Normalized 1-D Gaussian taps [2*radius+1] for a dynamic sigma, clamped
    away from 0 so the kernel degrades to a crisp delta."""
    sigma = torch.clamp_min(torch.as_tensor(sigma, dtype=torch.float32, device=device), 1e-3)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    return w / torch.sum(w)


def _pass_same(x: torch.Tensor, w: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """"SAME" zero-padded 1-D filter of x along dim: out[i] = sum_k w[k] *
    x[i + k - radius], in tap order. The padding is `radius` on each side,
    whatever the canvas size, so a radius past the canvas is covered."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = radius
    z = x.new_zeros(shape)
    xp = torch.cat([z, x, z], dim=dim)
    out = xp.narrow(dim, 0, n) * w[0]
    for k in range(1, 2 * radius + 1):
        out = out + xp.narrow(dim, k, n) * w[k]
    return out


def blur_image(img: torch.Tensor, sigma, radius: int) -> torch.Tensor:
    """Separable Gaussian blur of [H, W, C] with renormalized edges.

    The edges divide by the blurred all-ones canvas, so flat regions stay
    flat up to the border and the DC level is kept. `radius` is static (pick
    >= ceil(3*sigma_max)); sigma is dynamic."""
    img = img.to(torch.float32)
    w = gaussian_kernel(sigma, radius, device=img.device)
    # the image's channels and an all-ones channel, filtered together:
    # rows (the conv's kh pass) first, then columns
    x = torch.cat([img, torch.ones_like(img[..., :1])], dim=-1)
    x = _pass_same(_pass_same(x, w, radius, 0), w, radius, 1)
    return x[..., :-1] / x[..., -1:]


def sigma_schedule(gen: int, total_gens: int, sigma0: float, frac: float = 0.6,
                   sigma_end: float = 0.5) -> float:
    """Host-side schedule: geometric decay sigma0 -> sigma_end over the
    first `frac` of the budget, then exactly 0. Returns a plain float;
    values below SIGMA_SNAP snap to 0.0 so callers can branch to the
    unblurred path."""
    if sigma0 <= 0.0 or total_gens <= 0:
        return 0.0
    t_anneal = max(1.0, frac * total_gens)
    if gen >= t_anneal:
        return 0.0
    s = sigma0 * (sigma_end / sigma0) ** (gen / t_anneal)
    return float(s) if s > SIGMA_SNAP else 0.0


def sigma_step(gen: int, total: int, sigma0: float, frac: float, cur_sigma: float,
               target: torch.Tensor, radius: int):
    """The run loops' sigma at a block start: None while the schedule's sigma
    equals cur_sigma, else (sigma, sigma as a 0-d tensor on the target's
    device or None at 0, the target blurred at sigma or the target itself).
    The tensor is made by a fill, so no copy from the host."""
    s = sigma_schedule(gen, total, sigma0, frac)
    if s == cur_sigma:
        return None
    if s == 0.0:
        return s, None, target
    sigma_t = torch.full((), s, dtype=torch.float32, device=target.device)
    return s, sigma_t, blur_image(target, sigma_t, radius)


def default_radius(sigma0: float) -> int:
    """Static filter radius covering the largest sigma of the run."""
    return max(1, int(math.ceil(3.0 * sigma0)))
