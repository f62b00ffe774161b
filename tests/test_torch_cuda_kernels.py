"""The port's CUDA kernels (csrc/walk.cu: K1 fitness_tiles, K2 render_tiles)
against their plain PyTorch versions on the card, at the GA main path's
shapes (512x512, N=512, B=32, 64x128 tiles), on an odd canvas, and with
bin_capacity truncating the lists; plus the wrappers' argument checks.

Needs an NVIDIA card and nvcc: marked `cuda`, skipped elsewhere. Run on
the card with `python -m pytest tests/ -m cuda -q`. Tolerances: canvas
atol 2e-6 and fitness rtol 5e-5 (the kernel builds with -fmad=false and
the accurate expf, so both sides round the same operations; what remains
is the order of the per-tile sums)."""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from ggs_tpu_torch.ops import render_cuda

    render_cuda.build()
    return torch.device("cuda")


def _case(dev, B, N, H, W, precision, cap=None, tile_h=64, tile_w=128, seed=0):
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, mask, render_cuda
    from ggs_tpu_torch.utils import io

    gen = torch.Generator(device=dev).manual_seed(seed)
    g9 = codec.genome_to_renderer(genome.new_population(gen, B, N, H, W, device=dev))
    cnt, idx, feats, n_tx, n_ty = render_cuda._prepare(
        g9, H, W, 3.0, precision, cap, tile_h, tile_w
    )
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device=dev)
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    tgt_p = torch.zeros((3, Hp, Wp), device=dev)
    tgt_p[:, :H, :W] = tgt.permute(2, 0, 1)
    w_p = torch.zeros((Hp, Wp), device=dev)
    w_p[:H, :W] = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
    return cnt, idx, feats, tgt_p, w_p, n_tx


@pytest.mark.parametrize(
    "B,N,H,W,precision,cap",
    [
        (32, 512, 512, 512, "exact-tight", None),  # the main path
        (32, 512, 512, 512, "highest", None),
        (4, 96, 200, 328, "exact-tight", None),  # odd canvas: padded tiles
        (4, 96, 200, 328, "highest", 8),  # bin_capacity below the largest count
    ],
)
def test_kernels_match_plain(dev, B, N, H, W, precision, cap):
    from ggs_tpu_torch.ops import render_cuda as rc

    cnt, idx, feats, tgt_p, w_p, n_tx = _case(dev, B, N, H, W, precision, cap)
    if cap is not None:
        assert int(cnt.max()) == cap  # lists were truncated
    bg = (1.0, 1.0, 1.0)
    k2 = rc.render_tiles(cnt, idx, feats, n_tx, 64, 128, bg)
    p2 = rc.render_tiles_plain(cnt, idx, feats, n_tx, 64, 128, bg, *k2.shape[2:])
    torch.testing.assert_close(k2, p2, atol=2e-6, rtol=0)
    k1 = rc.fitness_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg)
    p1 = rc.fitness_tiles_plain(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg)
    torch.testing.assert_close(k1.sum(1), p1.sum(1), rtol=5e-5, atol=0)
    # fixed-order reduction: the same bits on a second launch
    assert torch.equal(k1, rc.fitness_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg))


def test_launch_counts_and_small_tiles(dev):
    from ggs_tpu_torch.ops import render_cuda as rc

    cnt, idx, feats, tgt_p, w_p, n_tx = _case(dev, 3, 32, 40, 200, "exact-tight", tile_h=16)
    bg = (0.2, 0.4, 0.6)
    n1, n2 = rc.fitness_tiles.launches, rc.render_tiles.launches
    k2 = rc.render_tiles(cnt, idx, feats, n_tx, 16, 128, bg)
    k1 = rc.fitness_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, 16, 128, bg)
    assert (rc.fitness_tiles.launches, rc.render_tiles.launches) == (n1 + 1, n2 + 1)
    torch.testing.assert_close(
        k2, rc.render_tiles_plain(cnt, idx, feats, n_tx, 16, 128, bg, *k2.shape[2:]),
        atol=2e-6, rtol=0,
    )
    torch.testing.assert_close(
        k1.sum(1), rc.fitness_tiles_plain(cnt, idx, feats, tgt_p, w_p, n_tx, 16, 128, bg).sum(1),
        rtol=5e-5, atol=0,
    )


def test_wrappers_reject_bad_arguments(dev):
    from ggs_tpu_torch.ops import render_cuda as rc

    cnt, idx, feats, tgt_p, w_p, n_tx = _case(dev, 2, 16, 64, 128, "highest")
    bg = (1.0, 1.0, 1.0)
    with pytest.raises(TypeError):
        rc.render_tiles(cnt.long(), idx, feats, n_tx, 64, 128, bg)
    with pytest.raises(TypeError):
        rc.fitness_tiles(cnt, idx, feats.double(), tgt_p, w_p, n_tx, 64, 128, bg)
    with pytest.raises(ValueError):
        rc.fitness_tiles(cnt, idx, feats, tgt_p[:, :-1], w_p, n_tx, 64, 128, bg)
    with pytest.raises(ValueError):
        rc.render_tiles(cnt, idx.transpose(0, 1), feats, n_tx, 64, 128, bg)
    with pytest.raises(ValueError):
        rc.render_tiles(cnt.cpu(), idx, feats, n_tx, 64, 128, bg)
    with pytest.raises(ValueError):  # a tile the block cannot cover
        rc.render_tiles(cnt, idx, feats, n_tx, 64, 96, bg)
