"""Image IO for the port (ggs_tpu/utils/io.py): target loading, the
procedural targets ("synthetic", quality_target's five families and the
bundled "photo"), resizing to the working size, PNG export, video frames
and their APNG animation.

The targets are numpy on both sides and equal to the JAX package's array
for array. Frames render the best genome with K2 at B=1 (one copy to the
host a frame, taken between run blocks) and are written as PNGs by one
background thread, at most _MAX_PENDING frames behind (the JAX package's
native writer queues 8); `flush_frames` waits for them. `assemble_apng`
writes the animation with the standard library's zlib, one APNG frame per
frame PNG (Pillow's writer would merge identical consecutive frames).
"""
from __future__ import annotations

import concurrent.futures
import glob
import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from ..ops.mask import resize_bilinear


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


def _value_noise(rng, H: int, W: int, grid: int) -> np.ndarray:
    """One octave of bilinear value noise on a (grid+1)² lattice -> [H, W]."""
    lat = rng.uniform(0.0, 1.0, (grid + 1, grid + 1)).astype(np.float32)
    y = np.linspace(0.0, grid, H, dtype=np.float32)
    x = np.linspace(0.0, grid, W, dtype=np.float32)
    yi = np.minimum(y.astype(np.int32), grid - 1)
    xi = np.minimum(x.astype(np.int32), grid - 1)
    fy = (y - yi)[:, None]
    fx = (x - xi)[None, :]
    a = lat[yi][:, xi]
    b = lat[yi][:, xi + 1]
    c = lat[yi + 1][:, xi]
    d = lat[yi + 1][:, xi + 1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def _pink_field(rng, H: int, W: int, slope: float = 1.0) -> np.ndarray:
    """Zero-mean unit-variance Gaussian field with amplitude ∝ f^-slope
    (power spectrum ∝ f^-2·slope — slope=1 gives the natural-image 1/f²
    power law), synthesized in the Fourier domain -> [H, W] float32."""
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.rfftfreq(W)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    with np.errstate(divide="ignore"):
        amp = np.where(f > 0.0, f ** -slope, 0.0)
    spec = amp * (
        rng.normal(size=(H, W // 2 + 1)) + 1j * rng.normal(size=(H, W // 2 + 1))
    )
    x = np.fft.irfft2(spec, s=(H, W))
    return ((x - x.mean()) / (x.std() + 1e-12)).astype(np.float32)


def quality_target(family: str, H: int = 512, W: int = 512) -> np.ndarray:
    """Deterministic procedural targets spanning image families with
    distinct spectral/structural character, float32 [H, W, 3] in [0, 1].

    Built for benchmarks/quality.py: the fast-mode ε-cull's quality
    behavior is image-family-dependent (docs/DESIGN.md §8d measured a
    uniform-noise-vs-natural asymmetry), so its selection-safety claim is
    validated across these families, not one target. Families:

      gradient  smooth linear+radial ramps — zero high-frequency content;
                sensitive to any systematic energy bias.
      portrait  center-heavy smooth blobs with small high-contrast
                features (face-like spatial statistics).
      texture   4-octave fractal value noise per channel — broadband
                spatial frequency, no flat regions.
      text      glyph-like random strokes on a paper ramp — thin
                hard-edged structure, the splat-hostile extreme.
      natural   measured natural-image statistics, synthesized (round-5,
                VERDICT r4 item 1): 1/f² luminance power spectrum
                (_pink_field; radial slope numerically pinned in
                tests/test_io.py::test_natural_family_spectrum_slope),
                occlusion edges from depth-ordered textured ellipses
                (step edges are themselves a 1/f² process), chroma
                carried on the luminance (spatially correlated, lower
                bandwidth), mild sensor noise and 8-bit quantization —
                the capture chain of run_ggs.py:33's photograph use case.

    Plus "synthetic" (synthetic_target) and the bundled real photograph
    ("photo", _photo_target), addressed via load_image. No file IO except
    the photo; numpy-only; fixed internal seeds.
    """
    u, v = np.meshgrid(
        np.linspace(0.0, 1.0, W, dtype=np.float32),
        np.linspace(0.0, 1.0, H, dtype=np.float32),
    )
    if family == "gradient":
        r = np.sqrt((u - 0.35) ** 2 + (v - 0.4) ** 2)
        img = np.stack(
            [
                0.15 + 0.7 * u,
                0.2 + 0.6 * np.clip(1.2 - 1.4 * r, 0.0, 1.0),
                0.8 - 0.5 * v,
            ],
            axis=-1,
        )
    elif family == "portrait":
        rng = np.random.default_rng(7)
        img = np.stack(  # dim backdrop vignette
            [0.18 + 0.10 * v, 0.16 + 0.08 * v, 0.22 + 0.06 * u], axis=-1
        )

        def blob(cx, cy, sx, sy, col, a, th=0.0):
            dx, dy = u - cx, v - cy
            rx = np.cos(th) * dx + np.sin(th) * dy
            ry = -np.sin(th) * dx + np.cos(th) * dy
            f = a * np.exp(-0.5 * ((rx / sx) ** 2 + (ry / sy) ** 2))
            return (1.0 - f[..., None]) * img + f[..., None] * np.asarray(
                col, np.float32
            )

        img = blob(0.5, 0.95, 0.30, 0.35, (0.35, 0.25, 0.40), 0.95)  # torso
        img = blob(0.5, 0.42, 0.16, 0.21, (0.85, 0.65, 0.52), 0.98)  # head
        img = blob(0.5, 0.22, 0.19, 0.12, (0.25, 0.16, 0.10), 0.95)  # hair
        img = blob(0.43, 0.40, 0.025, 0.016, (0.08, 0.07, 0.09), 0.97)  # eyes
        img = blob(0.57, 0.40, 0.025, 0.016, (0.08, 0.07, 0.09), 0.97)
        img = blob(0.5, 0.47, 0.012, 0.03, (0.75, 0.52, 0.42), 0.6)  # nose
        img = blob(0.5, 0.545, 0.045, 0.012, (0.65, 0.25, 0.28), 0.9)  # mouth
        img = blob(0.40, 0.47, 0.035, 0.025, (0.92, 0.70, 0.60), 0.4)  # cheeks
        img = blob(0.60, 0.47, 0.035, 0.025, (0.92, 0.70, 0.60), 0.4)
        for _ in range(4):  # soft background bokeh
            img = blob(
                rng.uniform(0.05, 0.95), rng.uniform(0.05, 0.95),
                rng.uniform(0.05, 0.12), rng.uniform(0.05, 0.12),
                rng.uniform(0.2, 0.6, 3), 0.35, rng.uniform(0, np.pi),
            )
    elif family == "texture":
        rng = np.random.default_rng(11)
        chans = []
        for _ in range(3):
            acc = np.zeros((H, W), np.float32)
            amp, tot = 1.0, 0.0
            for g in (4, 8, 16, 32):
                acc += amp * _value_noise(rng, H, W, g)
                tot += amp
                amp *= 0.55
            chans.append(acc / tot)
        img = np.stack(chans, axis=-1)
        img = 0.15 + 0.7 * (0.6 * img + 0.4 * img.mean(-1, keepdims=True))
    elif family == "text":
        rng = np.random.default_rng(3)
        img = np.stack(  # paper with a slight ramp
            [0.88 - 0.08 * v, 0.86 - 0.06 * v, 0.80 + 0.05 * u], axis=-1
        )
        cell = max(H // 16, 8)
        ink = np.zeros((H, W), bool)
        for cy in range(1, H // cell - 1):
            for cx in range(1, W // cell - 1):
                if rng.uniform() < 0.25:
                    continue
                y0, x0 = cy * cell, cx * cell
                for _ in range(rng.integers(2, 5)):  # strokes in the cell
                    horiz = rng.uniform() < 0.5
                    t = rng.integers(1, max(cell // 8, 2) + 1)  # thickness
                    off = rng.integers(1, cell - t)
                    lo = rng.integers(1, cell // 2)
                    hi = rng.integers(cell // 2, cell - 1)
                    if horiz:
                        ink[y0 + off:y0 + off + t, x0 + lo:x0 + hi] = True
                    else:
                        ink[y0 + lo:y0 + hi, x0 + off:x0 + off + t] = True
        img[ink] = (0.08, 0.08, 0.12)
    elif family == "natural":
        rng = np.random.default_rng(19)
        # 1/f² luminance base + a shallow illumination gradient
        L = 0.48 + 0.04 * (u - v) + 0.15 * _pink_field(rng, H, W)
        # depth-ordered occluding ellipses, each a flat albedo carrying
        # its own low-amplitude 1/f² texture: occlusion step edges
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
        # chroma carried on the luminance (correlated), lower spatial
        # bandwidth than L (slope 1.3 > 1.0) and lower amplitude —
        # natural images concentrate energy in the luminance plane
        cb = 0.06 * _pink_field(rng, H, W, slope=1.3)
        cr = 0.06 * _pink_field(rng, H, W, slope=1.3)
        img = np.stack(
            [L + 1.0 * cr, L - 0.34 * cr - 0.17 * cb, L + 1.0 * cb], axis=-1
        )
        # capture chain: mild sensor noise, then 8-bit quantization
        img = img + rng.normal(0.0, 1.5 / 255.0, img.shape)
        img = np.round(np.clip(img, 0.0, 1.0) * 255.0) / 255.0
    else:
        raise ValueError(
            f"unknown quality-target family {family!r} "
            "(gradient|portrait|texture|text|natural)"
        )
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _photo_target(H: int = 512, W: int = 512) -> np.ndarray:
    """The bundled real photograph -> float32 [H, W, 3] in [0, 1].

    assets/photo.png is the port's own copy of the JAX package's: a lossless
    512×512 center crop of matplotlib's public-domain sample photo
    (grace_hopper.jpg, a US Navy portrait), resized bilinearly by PIL when
    another size is asked for."""
    from PIL import Image

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "photo.png",
    )
    im = Image.open(path).convert("RGB")
    if im.size != (W, H):
        im = im.resize((W, H), Image.BILINEAR)
    return np.asarray(im, dtype=np.float32) / 255.0


_PROCEDURAL_FAMILIES = (
    "synthetic", "gradient", "portrait", "texture", "text", "natural"
)


def load_image(path: str) -> np.ndarray:
    """Load an RGB image -> float32 [H, W, 3] in [0, 1] (run_ggs.py:33-36).

    The literal names "synthetic", "gradient", "portrait", "texture",
    "text", "natural" (each optionally ":HxW") return deterministic
    procedural targets instead of reading a file; "photo[:HxW]" returns
    the bundled real photograph (_photo_target)."""
    fam, _, size = path.partition(":")
    if fam in _PROCEDURAL_FAMILIES or fam == "photo":
        h, w = (int(s) for s in size.lower().split("x")) if size else (512, 512)
        if fam == "photo":
            return _photo_target(h, w)
        return synthetic_target(h, w) if fam == "synthetic" else quality_target(fam, h, w)
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


def render_genome_to_u8(ind_axes_angle, H: int, W: int, k_sigma: float, impl: str = "cuda"
                        ) -> np.ndarray:
    """Axes-angle genome [N, 9] -> uint8 image [H, W, 3] (modules/utils.py:49-58):
    one render at B=1 (K2 under impl "cuda") and one copy to the host."""
    from ..ops import codec, render

    g9 = codec.genome_to_renderer(torch.as_tensor(ind_axes_angle, dtype=torch.float32))
    img = render.render_splats(g9[None], H, W, k_sigma=k_sigma, impl=impl)[0]
    return (np.clip(img.cpu().numpy(), 0.0, 1.0) * 255.0).astype(np.uint8)


_MAX_PENDING = 8
_writer: Optional[concurrent.futures.ThreadPoolExecutor] = None
_pending: list = []


def _write_png(path: str, img8: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img8).save(path)


def save_frame_png(gen: int, ind_axes_angle, pad: int, prefix: str, video_dir: str, H: int,
                   W: int, k_sigma: float, impl: str = "cuda") -> str:
    """Snapshot the best individual to video_dir/{prefix}_{gen:0pad}.png
    (modules/utils.py:62-69). The PNG is encoded and written by a background
    thread; the oldest pending write is waited for once _MAX_PENDING are."""
    global _writer
    img8 = render_genome_to_u8(ind_axes_angle, H, W, k_sigma, impl=impl)
    os.makedirs(video_dir, exist_ok=True)
    path = os.path.join(video_dir, f"{prefix}_{gen:0{pad}d}.png")
    if _writer is None:
        _writer = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                        thread_name_prefix="frame-writer")
    while len(_pending) >= _MAX_PENDING:
        _pending.pop(0).result()
    _pending.append(_writer.submit(_write_png, path, img8))
    return path


def flush_frames() -> None:
    """Wait for every queued frame write to reach the disk; a failed write
    raises here."""
    while _pending:
        _pending.pop(0).result()


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def assemble_apng(video_dir: str, prefix: str, out_path: str, fps: int = 30) -> Optional[str]:
    """Assemble video_dir/{prefix}_*.png, in name order, into one looping APNG
    at `fps`, one animation frame per PNG. Frames whose size or mode differs
    from the first are skipped (a resolution change mid-run). Returns the
    output path, or None when there are no frames."""
    from PIL import Image

    flush_frames()
    frames = sorted(glob.glob(os.path.join(video_dir, f"{prefix}_*.png")))
    if not frames:
        return None
    first = np.asarray(Image.open(frames[0]).convert("RGB"))
    H, W = first.shape[:2]
    keep = []
    for f in frames:
        with Image.open(f) as im:  # the header only
            if im.size == (W, H):
                keep.append(f)
    out_dir = os.path.dirname(out_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    seq = 0
    with open(out_path, "wb") as out:
        out.write(b"\x89PNG\r\n\x1a\n")
        # 8-bit RGB, no interlace; acTL: the frame count, loop forever
        out.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        out.write(_png_chunk(b"acTL", struct.pack(">II", len(keep), 0)))
        for i, f in enumerate(keep):
            arr = np.asarray(Image.open(f).convert("RGB"), dtype=np.uint8)
            # each row behind filter byte 0 (none)
            raw = np.concatenate([np.zeros((H, 1), np.uint8), arr.reshape(H, W * 3)], axis=1)
            data = zlib.compress(raw.tobytes(), 6)
            # fcTL: full-canvas frame, delay 1/fps s, dispose none, blend source
            out.write(_png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, W, H, 0, 0, 1,
                                                      max(1, fps), 0, 0)))
            seq += 1
            if i == 0:
                out.write(_png_chunk(b"IDAT", data))
            else:
                out.write(_png_chunk(b"fdAT", struct.pack(">I", seq) + data))
                seq += 1
        out.write(_png_chunk(b"IEND", b""))
    return out_path
