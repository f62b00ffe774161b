"""Seeded numpy inputs shared by the port's cross-check tests
(tests/test_torch_*.py): both packages receive the same float32 arrays."""
import numpy as np


def axes_genomes(seed: int, B: int, N: int, H: int, W: int, max_scale: float = 0.3):
    """Axes-angle genomes [B, N, 9] float32 spread over the genome's domain."""
    rng = np.random.default_rng(seed)
    hi = np.log(max(max_scale * max(H, W), 1.5))
    g = np.empty((B, N, 9), np.float32)
    g[..., 0:2] = rng.uniform(0.0, 1.0, (B, N, 2))
    g[..., 2:4] = rng.uniform(0.0, hi, (B, N, 2))
    g[..., 4] = rng.uniform(-np.pi, np.pi, (B, N))
    g[..., 5:8] = rng.uniform(0.0, 255.0, (B, N, 3))
    g[..., 8] = rng.uniform(60.0, 255.0, (B, N))
    return g


def image(seed: int, H: int, W: int):
    """A smooth-plus-noise target [H, W, 3] float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([x / W, y / H, 0.5 + 0.4 * np.sin(x / 7.0 + y / 11.0)], axis=-1)
    return np.clip(base + 0.1 * rng.standard_normal((H, W, 3)), 0.0, 1.0).astype(np.float32)


def weights(seed: int, H: int, W: int):
    """A positive weight plane [H, W] float32 in [0.15, 1]."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.15, 1.0, (H, W)).astype(np.float32)
