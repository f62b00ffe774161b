"""Image IO for the port (ggs_tpu/utils/io.py): target loading, the
procedural "synthetic" target, resizing to the working size, PNG export.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.mask import resize_bilinear

# procedural targets of the JAX package that this port does not generate yet
_UNPORTED_TARGETS = ("gradient", "portrait", "texture", "text", "natural", "photo")


def synthetic_target(H: int = 512, W: int = 512, seed: int = 0) -> np.ndarray:
    """Deterministic procedural target image, float32 [H, W, 3] in [0, 1]:
    smooth color gradients, anisotropic Gaussian blobs and two hard edges
    (the JAX package's synthetic_target, value for value)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    u, v = x / max(W - 1, 1), y / max(H - 1, 1)
    img = np.stack(
        [0.55 + 0.35 * u - 0.15 * v, 0.45 + 0.30 * v, 0.65 - 0.25 * u + 0.20 * v],
        axis=-1,
    )
    for _ in range(14):  # anisotropic Gaussian blobs
        cx, cy = rng.uniform(0.1, 0.9, 2)
        sx, sy = rng.uniform(0.03, 0.22, 2)
        th = rng.uniform(0, np.pi)
        col = rng.uniform(0, 1, 3).astype(np.float32)
        a = rng.uniform(0.5, 0.95)
        dx, dy = u - cx, v - cy
        rx = np.cos(th) * dx + np.sin(th) * dy
        ry = -np.sin(th) * dx + np.cos(th) * dy
        f = a * np.exp(-0.5 * ((rx / sx) ** 2 + (ry / sy) ** 2))
        img = (1.0 - f[..., None]) * img + f[..., None] * col
    # two hard-edged shapes for the edge cue
    img[(u > 0.62) & (u < 0.80) & (v > 0.15) & (v < 0.33)] = (0.95, 0.85, 0.25)
    disk = (u - 0.25) ** 2 + (v - 0.72) ** 2 < 0.012
    img[disk] = (0.15, 0.20, 0.55)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def load_image(path: str) -> np.ndarray:
    """Load an RGB image -> float32 [H, W, 3] in [0, 1] (run_ggs.py:33-36).
    The literal "synthetic[:HxW]" returns synthetic_target."""
    fam, _, size = path.partition(":")
    if fam == "synthetic":
        h, w = (int(s) for s in size.lower().split("x")) if size else (512, 512)
        return synthetic_target(h, w)
    if fam in _UNPORTED_TARGETS:
        raise NotImplementedError(f"procedural target {fam!r} is not ported yet")
    from PIL import Image

    pil = Image.open(path).convert("RGB")
    return np.asarray(pil, dtype=np.float32) / 255.0


def ensure_hw(target, H: int, W: int, device="cuda") -> torch.Tensor:
    """Scale to [0,1] float and bilinear-resize to (H, W) if needed
    (modules/algorithm.py:33-39)."""
    t = torch.as_tensor(target, dtype=torch.float32, device=device)
    t = torch.where(torch.max(t) > 1.5, t / 255.0, t)
    return resize_bilinear(t.permute(2, 0, 1), H, W).permute(1, 2, 0).contiguous()


def save_image_u8(img01, path: str) -> None:
    """Save a [H, W, 3] float image in [0,1] as PNG (run_ggs.py:69-77)."""
    from PIL import Image

    arr = torch.as_tensor(img01).detach().cpu().numpy()
    img8 = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img8).save(path)
