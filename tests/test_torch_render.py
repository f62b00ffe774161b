"""Port renderer (ggs_tpu_torch/ops/render_cuda.py, oracle.py, render.py)
against the JAX package on the same float32 inputs, on the CPU: the tiled
entry points take the plain versions of the K1/K2 kernels there, and the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.

Tolerances: bin lists and counts equal; fused fitness rtol 5e-5
(tests/test_render_pallas.py:140). Canvases: the port's tiled walk equals
its own dense oracle bit for bit (the same PyTorch exp on both sides, and
the table's folded constants are exact powers of two). Across packages the
canvas tolerance is CANVAS_ATOL = 4e-6 rather than the JAX suite's 1e-6
(:30): XLA's and PyTorch's CPU expf differ by 1-2 ulp, and each splat that
covers a pixel adds such a difference to its blend (N = 16 here; measured
worst 3.1e-6 over seeds 0-3, where the JAX package's own interpret-mode
kernel and its oracle already differ by up to 1.6e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import codec as jcodec
from ggs_tpu.ops import oracle as joracle
from ggs_tpu.ops import render_pallas as rp
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import oracle as toracle
from ggs_tpu_torch.ops import render as trender
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.utils import profiling
from torch_inputs import axes_genomes, image, pass_lists, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, TH, TW = 40, 200, 16, 128
CANVAS_ATOL = 4e-6


def _g9(seed, B=3, N=16, H=H, W=W, max_scale=0.3):
    g = axes_genomes(seed, B, N, H, W, max_scale)
    return np.array(jcodec.genome_to_renderer(jnp.asarray(g)))


def _screens(g9, precision, H=H, W=W):
    pj = jcodec.preprocess(jnp.asarray(g9), H, W, 3.0)
    pt = tcodec.preprocess(torch.from_numpy(g9), H, W, 3.0)
    if precision == "exact-tight":
        pj = jcodec.tighten_boxes_exact(pj, 3.0)
        pt = tcodec.tighten_boxes_exact(pt, 3.0)
    return pj, pt


@pytest.mark.parametrize("precision", ["highest", "exact-tight"])
@pytest.mark.parametrize("cap", [24, 5])
def test_dense_binning_matches(precision, cap):
    g9 = _g9(0, B=3, N=24, max_scale=1.0)
    pj, pt = _screens(g9, precision)
    n_tx, n_ty = -(-W // TW), -(-H // TH)
    ij, cj = rp._bin_splats_dense(pj.x0, pj.x1, pj.y0, pj.y1, n_tx, n_ty, TH, TW, cap)
    it, ct = rc.bin_splats_dense(pt.x0, pt.x1, pt.y0, pt.y1, n_tx, n_ty, TH, TW, cap)
    assert it.dtype == torch.int32 and ct.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    if cap < 24:  # the truncation rule is exercised
        _, full = rc.bin_splats_dense(pt.x0, pt.x1, pt.y0, pt.y1, n_tx, n_ty, TH, TW, 24)
        assert int(full.max()) > cap


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("box", ["reference", "tight"])
def test_oracle_matches_render_xla(box, seed):
    g9 = _g9(seed, B=2, N=16, max_scale=0.5)
    ref = joracle.render_xla(jnp.asarray(g9), H, W, box=box)
    got = toracle.render_dense(torch.from_numpy(g9), H, W, box=box)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=CANVAS_ATOL)


@pytest.mark.parametrize(
    "precision,Hc,Wc,th", [("highest", H, W, 16), ("exact-tight", 75, 131, 16), ("exact-tight", 64, 256, 64)]
)
def test_tiled_walk_equals_port_oracle(precision, Hc, Wc, th):
    """The K2 path's plain version reproduces the dense oracle exactly."""
    g9 = torch.from_numpy(_g9(6, B=3, N=24, H=Hc, W=Wc, max_scale=0.5))
    box = "tight" if precision == "exact-tight" else "reference"
    ref = toracle.render_dense(g9, Hc, Wc, box=box)
    got = rc.render(g9, Hc, Wc, tile_h=th, tile_w=TW, precision=precision)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize(
    "precision,Hc,Wc,cap",
    [
        ("highest", H, W, None),
        ("exact-tight", H, W, None),
        ("exact-tight", 75, 131, None),  # odd canvas: padding on both axes
        ("highest", H, W, 4),  # bin_capacity < max cnt: truncation
    ],
)
def test_render_matches_render_pallas(precision, Hc, Wc, cap):
    """K2 path: render() vs render_pallas(interpret=True)."""
    g9 = _g9(2, B=3, N=16, H=Hc, W=Wc)
    ref = rp.render_pallas(
        jnp.asarray(g9), Hc, Wc, tile_h=TH, tile_w=TW, bin_capacity=cap,
        precision=precision, interpret=True,
    )
    got = rc.render(
        torch.from_numpy(g9), Hc, Wc, tile_h=TH, tile_w=TW, bin_capacity=cap,
        precision=precision,
    )
    assert got.shape == (3, Hc, Wc, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=CANVAS_ATOL)


@pytest.mark.parametrize("precision", ["highest", "exact-tight"])
@pytest.mark.parametrize("mode", ["plain", "weighted", "boost"])
def test_fitness_matches_fitness_pallas(precision, mode):
    """K1 path: fitness() vs fitness_pallas(interpret=True), all three
    scoring modes."""
    g9 = _g9(3, B=3, N=16)
    tgt = image(3, H, W)
    wm = None if mode == "plain" else weights(3, H, W)
    boost = mode == "boost"
    ref = rp.fitness_pallas(
        jnp.asarray(g9), jnp.asarray(tgt), None if wm is None else jnp.asarray(wm), H, W,
        boost_only=boost, boost_beta=0.8, tile_h=TH, tile_w=TW, precision=precision,
        interpret=True,
    )
    got = rc.fitness(
        torch.from_numpy(g9), torch.from_numpy(tgt), None if wm is None else torch.from_numpy(wm),
        H, W, boost_only=boost, boost_beta=0.8, tile_h=TH, tile_w=TW, precision=precision,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5)


def test_epilogues_agree_and_cpu_takes_plain():
    """K1's partials equal the weighted SSE of K2's canvas over each tile;
    on CPU tensors neither wrapper counts a launch."""
    g9 = torch.from_numpy(_g9(4, B=2, N=20))
    cnt, idx, feats, n_tx, n_ty = pass_lists(g9, H, W, 3.0, "exact-tight", None, TH, TW)
    Hp, Wp = n_ty * TH, n_tx * TW
    tgt = torch.zeros((3, Hp, Wp))
    tgt[:, :H, :W] = torch.from_numpy(image(4, H, W)).permute(2, 0, 1)
    w = torch.zeros((Hp, Wp))
    w[:H, :W] = torch.from_numpy(weights(4, H, W))
    before = (profiling.COUNTS["K1"], profiling.COUNTS["K2"])
    bg = (1.0, 1.0, 1.0)
    canvas = rc.render_tiles(cnt, idx, feats, n_tx, TH, TW, bg)
    partials = rc.fitness_tiles(cnt, idx, feats, tgt, w, n_tx, TH, TW, bg)
    assert (profiling.COUNTS["K1"], profiling.COUNTS["K2"]) == before
    assert canvas.shape == (2, 3, Hp, Wp) and partials.shape == (2, n_tx * n_ty)
    sse = (((canvas - tgt[None]) ** 2).sum(1) * w[None])  # [B, Hp, Wp]
    per_tile = sse.reshape(2, n_ty, TH, n_tx, TW).sum((2, 4)).reshape(2, -1)
    np.testing.assert_allclose(partials.numpy(), per_tile.numpy(), rtol=1e-5)


def test_render_splats_dispatch():
    g9 = torch.from_numpy(_g9(5, B=2, N=12))
    for precision in ("highest", "exact-tight"):
        a = trender.render_splats(g9, H, W, impl="oracle", precision=precision)
        b = trender.render_splats(g9, H, W, impl="cuda", tile_h=TH, precision=precision)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the fast tiers are ported: "bf16" renders as "highest", "fast" walks K3
    a = trender.render_splats(g9, H, W, impl="oracle", precision="bf16")
    b = trender.render_splats(g9, H, W, impl="cuda", tile_h=TH, precision="bf16")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    fast = trender.render_splats(g9, H, W, impl="cuda", tile_h=TH, precision="fast")
    np.testing.assert_array_equal(fast.numpy(), rc.render(g9, H, W, tile_h=TH, precision="fast").numpy())
    with pytest.raises(ValueError):
        trender.render_splats(g9, H, W, impl="xla")
