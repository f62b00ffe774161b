"""The inputs that the benchmark makes and hands to both the program and the
reference: the target image of a configuration.

`natural` is a frozen copy of the procedural "natural" target of
ggs_tpu_torch/utils/io.py:74-88 (`_pink_field`) and :118-121, :201-227
(`quality_target("natural")`): a 1/f^2 luminance field, depth-ordered
textured ellipses, correlated chroma, sensor noise and 8-bit quantisation,
from fixed internal seeds. `photo` reads the PNG that the configuration
names (under portbench/data/).
"""
from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pink_field(rng, H: int, W: int, slope: float = 1.0) -> np.ndarray:
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.rfftfreq(W)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    with np.errstate(divide="ignore"):
        amp = np.where(f > 0.0, f ** -slope, 0.0)
    spec = amp * (rng.normal(size=(H, W // 2 + 1)) + 1j * rng.normal(size=(H, W // 2 + 1)))
    x = np.fft.irfft2(spec, s=(H, W))
    return ((x - x.mean()) / (x.std() + 1e-12)).astype(np.float32)


def natural(H: int, W: int) -> np.ndarray:
    """The "natural" target, float32 [H, W, 3] in [0, 1]."""
    u, v = np.meshgrid(np.linspace(0.0, 1.0, W, dtype=np.float32),
                       np.linspace(0.0, 1.0, H, dtype=np.float32))
    rng = np.random.default_rng(19)
    L = 0.48 + 0.04 * (u - v) + 0.15 * _pink_field(rng, H, W)
    for _ in range(10):
        cx, cy = rng.uniform(0.08, 0.92, 2)
        ea, eb = rng.uniform(0.05, 0.30, 2)
        th = rng.uniform(0, np.pi)
        dx, dy = u - cx, v - cy
        rx = np.cos(th) * dx + np.sin(th) * dy
        ry = -np.sin(th) * dx + np.cos(th) * dy
        m = (rx / ea) ** 2 + (ry / eb) ** 2 < 1.0
        shade = rng.uniform(0.25, 0.75) + 0.08 * _pink_field(rng, H, W)
        L = np.where(m, shade, L)
    L = np.clip(L, 0.03, 0.97)
    cb = 0.06 * _pink_field(rng, H, W, slope=1.3)
    cr = 0.06 * _pink_field(rng, H, W, slope=1.3)
    img = np.stack([L + 1.0 * cr, L - 0.34 * cr - 0.17 * cb, L + 1.0 * cb], axis=-1)
    img = img + rng.normal(0.0, 1.5 / 255.0, img.shape)
    img = np.round(np.clip(img, 0.0, 1.0) * 255.0) / 255.0
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def photo(path: str) -> np.ndarray:
    """An RGB PNG -> float32 [H, W, 3] in [0, 1]."""
    from PIL import Image

    im = Image.open(os.path.join(ROOT, path)).convert("RGB")
    return np.asarray(im, dtype=np.float32) / 255.0


def target(config: dict) -> np.ndarray:
    """The configuration's target at its work size, float32 [H, W, 3]."""
    t = config["target"]
    H, W = config["height"], config["width"]
    img = natural(H, W) if t["kind"] == "natural" else photo(t["file"])
    if img.shape[:2] != (H, W):
        raise ValueError(f"target is {img.shape[:2]}, the configuration says {(H, W)}")
    return img
