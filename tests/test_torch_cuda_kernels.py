"""The port's CUDA kernels (csrc/walk.cu: K1 fitness_tiles, K2 render_tiles,
K3 fitness_tiles_fast/render_tiles_fast, K4 prep_fast, K1-bf16
fitness_tiles_bf16; csrc/walk_grad.cu: K6 bwd_tiles, K7 lossgrad_tiles;
csrc/scatter.cu: K5 bin_splats_scatter) against their plain PyTorch versions
on the card, at the GA main path's shapes (512x512, N=512, B=32, 64x128
tiles), on an odd canvas, with bin_capacity truncating the lists, at the
gradient paths' shapes (16x128 tiles) and at every list tile height the
gradient kernels walk (8, 16, 32 and 64 rows), with an init canvas (a
chained pass), with more sub-tile items than resident blocks (the blocks
take them from a queue; eagerly and replayed in a CUDA graph), and K5 at
256 tiles and more with and without the corner cull and with its overflow
fallback, and bin_splats' exact lists (K5 at every tile
count) at the benchmark cells' shapes; plus the wrappers' argument checks.

Needs an NVIDIA card and nvcc: marked `cuda`, skipped elsewhere. Run on
the card with `python -m pytest tests/ -m cuda -q`. Tolerances: canvas
atol 2e-6 and fitness rtol 5e-5 (the kernel builds with -fmad=false and
the accurate expf, so both sides round the same operations; what remains
is the order of the per-tile sums); each of the 9 gradient rows (one field
over every image and splat) within 1e-5 of that row's largest plain
magnitude (sums over a tile's pixels in another order); K4's table within
2 ulp with equal boxes and -inf entries; K1-bf16's fitness rtol 1e-5 (bf16
roundings of equal inputs; chip_smoke.py measured 2.2e-7 on an H100), and more than 1e-4
from K1's on the same lists (the bf16 roundings show); K5's lists, counts
and largest true count equal to its plain version's."""
import pytest
import torch

from torch_inputs import pass_lists

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from ggs_tpu_torch.ops import render_cuda

    render_cuda.build()
    return torch.device("cuda")


def _counts(*keys) -> tuple:
    """profiling.COUNTS at these keys."""
    from ggs_tpu_torch.utils import profiling

    return tuple(profiling.COUNTS[k] for k in keys)


def _row_err(got, want):
    """[9]: max |got - want| of each row of [B, 9, N] over its largest |want|."""
    return (got - want).abs().amax(dim=(0, 2)) / want.abs().amax(dim=(0, 2)).clamp_min(1e-30)


def _case(dev, B, N, H, W, precision, cap=None, tile_h=64, tile_w=128, seed=0, cull_eps=None,
          genomes=False):
    """The walk's inputs; under "fast" fast fitness's route (K4's table and
    boxes, corner-culled lists). genomes=True also returns the renderer genomes."""
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, mask, render_cuda
    from ggs_tpu_torch.utils import io

    gen = torch.Generator(device=dev).manual_seed(seed)
    g9 = codec.genome_to_renderer(genome.new_population(gen, B, N, H, W, device=dev))
    cnt, idx, feats, n_tx, n_ty = pass_lists(
        g9, H, W, 3.0, precision, cap, tile_h, tile_w, cull_eps, True, fitness_route=True
    )
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device=dev)
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    tgt_p = torch.zeros((3, Hp, Wp), device=dev)
    tgt_p[:, :H, :W] = tgt.permute(2, 0, 1)
    w_p = torch.zeros((Hp, Wp), device=dev)
    w_p[:H, :W] = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
    if genomes:
        return cnt, idx, feats, tgt_p, w_p, n_tx, g9
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
    p2 = rc.render_tiles_plain(cnt, idx, feats, n_tx, 64, 128, bg)
    torch.testing.assert_close(k2, p2, atol=2e-6, rtol=0)
    k1 = rc.fitness_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg)
    p1 = rc.fitness_tiles_plain(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg)
    torch.testing.assert_close(k1.sum(1), p1.sum(1), rtol=5e-5, atol=0)
    # fixed-order reduction: the same bits on a second launch
    assert torch.equal(k1, rc.fitness_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg))


@pytest.mark.parametrize(
    "B,N,H,W,eps",
    [
        (32, 512, 512, 512, 2e-3),  # the fast GA's main path
        (32, 512, 512, 512, 8e-2),
        (4, 256, 200, 328, 8e-2),  # odd canvas: padded tiles
    ],
)
def test_fast_kernels_match_plain(dev, B, N, H, W, eps):
    """K3 (both epilogues) on K4's lists and K4 itself against their plain
    versions; the same bits on a second launch; one count per launch."""
    from ggs_tpu_torch.ops import render_cuda as rc

    cnt, idx, ff, tgt_p, w_p, n_tx, g9 = _case(dev, B, N, H, W, "fast", seed=3, cull_eps=eps,
                                               genomes=True)
    bg = (1.0, 1.0, 1.0)
    counts = _counts("K3", "K3-canvas", "K4")
    k3c = rc.render_tiles_fast(cnt, idx, ff, n_tx, 64, 128, bg)
    p3c = rc.render_tiles_plain(cnt, idx, ff, n_tx, 64, 128, bg, mode="fast")
    torch.testing.assert_close(k3c, p3c, atol=2e-6, rtol=0)
    k3 = rc.fitness_tiles_fast(cnt, idx, ff, tgt_p, w_p, n_tx, 64, 128, bg)
    p3 = rc.fitness_tiles_plain(cnt, idx, ff, tgt_p, w_p, n_tx, 64, 128, bg, mode="fast")
    torch.testing.assert_close(k3.sum(1), p3.sum(1), rtol=5e-5, atol=0)
    assert torch.equal(k3, rc.fitness_tiles_fast(cnt, idx, ff, tgt_p, w_p, n_tx, 64, 128, bg))
    ff_p, fi_p = rc.prep_fast_plain(g9, H, W, 3.0, eps)
    fi = rc.prep_fast(g9, H, W, 3.0, eps)[1]
    assert torch.equal(ff.isneginf(), ff_p.isneginf()) and torch.equal(fi, fi_p)
    fin = ff_p.isfinite()
    ulps = (ff.view(torch.int32).long() - ff_p.view(torch.int32).long()).abs()[fin]
    assert int(ulps.max()) <= 2
    assert _counts("K3", "K3-canvas", "K4") == (counts[0] + 2, counts[1] + 1, counts[2] + 1)


def test_bf16_kernel_matches_plain(dev):
    """K1-bf16 against torch bf16 on the card, on the reference box's lists."""
    from ggs_tpu_torch.ops import render_cuda as rc

    cnt, idx, feats, tgt_p, w_p, n_tx = _case(dev, 32, 512, 512, 512, "bf16", seed=4)
    bg = (1.0, 1.0, 1.0)
    (n,) = _counts("K1-bf16")
    k = rc.fitness_tiles_bf16(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg)
    p = rc.fitness_tiles_plain(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg, mode="bf16")
    torch.testing.assert_close(k.sum(1), p.sum(1), rtol=1e-5, atol=0)
    f32 = rc.fitness_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg).sum(1)
    assert float((k.sum(1) / f32 - 1.0).abs().max()) > 1e-4
    assert torch.equal(k, rc.fitness_tiles_bf16(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg))
    assert _counts("K1-bf16") == (n + 2,)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones: no quiet fallback
        rc.fitness_tiles_bf16(cnt.cpu(), idx, feats, tgt_p, w_p, n_tx, 64, 128, bg)


def test_launch_counts_and_small_tiles(dev):
    from ggs_tpu_torch.ops import render_cuda as rc

    cnt, idx, feats, tgt_p, w_p, n_tx = _case(dev, 3, 32, 40, 200, "exact-tight", tile_h=16)
    bg = (0.2, 0.4, 0.6)
    n1, n2 = _counts("K1", "K2")
    k2 = rc.render_tiles(cnt, idx, feats, n_tx, 16, 128, bg)
    k1 = rc.fitness_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, 16, 128, bg)
    assert _counts("K1", "K2") == (n1 + 1, n2 + 1)
    torch.testing.assert_close(
        k2, rc.render_tiles_plain(cnt, idx, feats, n_tx, 16, 128, bg),
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


@pytest.mark.parametrize(
    "B,N,H,W",
    [
        (1, 2000, 512, 512),  # run_grad's default
        (8, 512, 512, 512),  # the memetic elite batch at run_ga's defaults
        (2, 70, 40, 200),  # odd canvas, lists across three replay chunks
    ],
)
def test_grad_kernels_match_plain(dev, B, N, H, W):
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, mask, render_cuda as rc, render_grad as rg
    from ggs_tpu_torch.utils import io

    th, tw = rg.GRAD_TILE_H, rg.GRAD_TILE_W
    gen = torch.Generator(device=dev).manual_seed(0)
    g9 = codec.genome_to_renderer(genome.new_population(gen, B, N, H, W, device=dev))
    cnt, idx, _, n_tx, n_ty = pass_lists(g9, H, W, 3.0, "exact-tight", None, th, tw)
    p = codec.tighten_boxes_exact(codec.preprocess(g9, H, W, 3.0), 3.0)
    feats = rg._splat_feats(p)
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device=dev)
    wm = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
    tgt_p, w_p = rc.pad_planes(tgt, wm, n_ty * th, n_tx * tw)
    bg = (1.0, 1.0, 1.0)
    n6, n7 = _counts("K6", "K7")
    num, g7 = rg.lossgrad_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, th, tw, bg, 2.0)
    num_p, g7_p = rg.lossgrad_tiles_plain(cnt, idx, feats, tgt_p, w_p, n_tx, th, tw, bg, 2.0)
    torch.testing.assert_close(num.sum(1), num_p.sum(1), rtol=5e-5, atol=0)
    k1 = rc.fitness_tiles(cnt, idx, rc._splat_feats_fast(p), tgt_p, w_p, n_tx, th, tw, bg)
    torch.testing.assert_close(num.sum(1), k1.sum(1), rtol=5e-5, atol=0)
    assert float(_row_err(g7, g7_p).max()) <= 1e-5

    canvas = rc.render_tiles(cnt, idx, rc._splat_feats_fast(p), n_tx, th, tw, bg)
    g_img = (2.0 * w_p * (canvas.clamp(0.0, 1.0) - tgt_p[None])).contiguous()
    g6, dinit = rg.bwd_tiles(cnt, idx, feats, g_img, n_tx, th, tw, bg)
    g6_p, _ = rg.bwd_tiles_plain(cnt, idx, feats, g_img, n_tx, th, tw, bg)
    assert dinit is None
    assert float(_row_err(g6, g6_p).max()) <= 1e-5
    assert float(_row_err(g6, g7).max()) <= 2e-6
    # no atomics: the same bits on a second launch
    assert torch.equal(g6, rg.bwd_tiles(cnt, idx, feats, g_img, n_tx, th, tw, bg)[0])
    num2, g7b = rg.lossgrad_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, th, tw, bg, 2.0)
    assert torch.equal(num, num2) and torch.equal(g7, g7b)
    assert _counts("K6", "K7") == (n6 + 2, n7 + 2)


def test_grad_entry_points_match_oracle_autograd(dev):
    """fused_value_and_grad (K7) and autograd through render_diff (K2 + K6)
    on the card against torch autograd through the dense oracle on the CPU."""
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, fitness, oracle, render_grad as rg
    from ggs_tpu_torch.utils import io

    H, W = 40, 200
    g = genome.new_population(torch.Generator().manual_seed(7), 2, 24, H, W, 1.0, 0.3, "cpu")
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device="cpu")
    gc = g.clone().requires_grad_(True)
    img = oracle.render_dense(codec.genome_to_renderer(gc), H, W, box="tight")
    (ref,) = torch.autograd.grad(fitness.fitness_from_images(img, tgt).mean(), gc)
    _, fused = rg.fused_value_and_grad(g.to(dev), tgt.to(dev), None, H, W, box="tight")
    gd = g.to(dev).requires_grad_(True)
    img_d = rg.render_diff(codec.genome_to_renderer(gd), H, W, box="tight")
    (unfused,) = torch.autograd.grad(fitness.fitness_from_images(img_d, tgt.to(dev)).mean(), gd)
    torch.testing.assert_close(fused.cpu(), ref, rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(unfused.cpu(), ref, rtol=1e-3, atol=1e-7)


def test_grad_wrappers_reject_bad_arguments(dev):
    from ggs_tpu_torch.ops import render_grad as rg

    cnt, idx, _, tgt_p, w_p, n_tx = _case(dev, 2, 16, 64, 128, "highest", tile_h=16)
    feats = torch.zeros((2, 13, 17), device=dev)
    bg = (1.0, 1.0, 1.0)
    g_img = torch.zeros((2, 3, 64, 128), device=dev)
    for th, tw in ((24, 128), (16, 64)):  # list tiles the kernels do not walk
        with pytest.raises(ValueError):
            rg.bwd_tiles(cnt, idx, feats, g_img, n_tx, th, tw, bg)
    with pytest.raises(TypeError):
        rg.bwd_tiles(cnt, idx, feats, g_img.double(), n_tx, 16, 128, bg)
    with pytest.raises(ValueError):
        rg.lossgrad_tiles(cnt, idx, feats, tgt_p[:, :-1], w_p, n_tx, 16, 128, bg, 2.0)


@pytest.mark.parametrize("tile_h", [8, 16, 32, 64])
def test_grad_kernels_at_list_tile_heights(dev, tile_h):
    """K6 (from the background and from an init canvas, with d(init)) and K7
    on list tiles of each height the kernels walk, against their plain
    versions: gradient rows within 1e-5, d(init) within 1e-5 of its largest
    value, K7's num within 5e-5 of K1's, the same bits twice."""
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, mask, render_cuda as rc, render_grad as rg
    from ggs_tpu_torch.utils import io

    B, N, H, W, tw = 2, 300, 200, 328, rg.GRAD_TILE_W
    gen = torch.Generator(device=dev).manual_seed(tile_h)
    g9 = codec.genome_to_renderer(genome.new_population(gen, B, N, H, W, device=dev))
    cnt, idx, _, n_tx, n_ty = pass_lists(g9, H, W, 3.0, "exact-tight", None, tile_h, tw)
    p = codec.tighten_boxes_exact(codec.preprocess(g9, H, W, 3.0), 3.0)
    feats = rg._splat_feats(p)
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device=dev)
    wm = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
    tgt_p, w_p = rc.pad_planes(tgt, wm, n_ty * tile_h, n_tx * tw)
    bg = (1.0, 1.0, 1.0)
    args = (cnt, idx, feats, tgt_p, w_p, n_tx, tile_h, tw, bg, 2.0)
    num, g7 = rg.lossgrad_tiles(*args)
    num_p, g7_p = rg.lossgrad_tiles_plain(*args)
    k1 = rc.fitness_tiles(cnt, idx, rc._splat_feats_fast(p), tgt_p, w_p, n_tx, tile_h, tw, bg)
    torch.testing.assert_close(num.sum(1), num_p.sum(1), rtol=5e-5, atol=0)
    torch.testing.assert_close(num.sum(1), k1.sum(1), rtol=5e-5, atol=0)
    assert float(_row_err(g7, g7_p).max()) <= 1e-5
    num2, g7b = rg.lossgrad_tiles(*args)
    assert torch.equal(num, num2) and torch.equal(g7, g7b)
    g_img = (_init(dev, B, *w_p.shape, seed=9) - 0.5).contiguous()
    for init in (None, _init(dev, B, *w_p.shape)):
        six = (cnt, idx, feats, g_img, n_tx, tile_h, tw, bg, init)
        g6, d6 = rg.bwd_tiles(*six)
        g6_p, d6_p = rg.bwd_tiles_plain(*six)
        assert float(_row_err(g6, g6_p).max()) <= 1e-5
        g6b, d6b = rg.bwd_tiles(*six)
        assert torch.equal(g6, g6b)
        if init is not None:
            assert float((d6 - d6_p).abs().max() / d6_p.abs().max()) <= 1e-5
            assert torch.equal(d6, d6b)


def _init(dev, B, Hp, Wp, seed=5):
    """A canvas a chained pass starts from, inside [0, 1]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((B, 3, Hp, Wp), generator=gen, device=dev) * 0.9 + 0.05


@pytest.mark.parametrize("precision", ["exact-tight", "fast", "bf16"])
def test_walks_with_init_match_plain(dev, precision):
    """K1/K2, K3 (both epilogues) and K1-bf16 from an init canvas against
    their plain versions from the same canvas, the same bits twice, and one
    init launch counted per launch."""
    from ggs_tpu_torch.ops import render_cuda as rc

    cnt, idx, feats, tgt_p, w_p, n_tx = _case(dev, 8, 256, 200, 328, precision, seed=6,
                                              cull_eps=8e-2)
    bg = (1.0, 1.0, 1.0)
    init = _init(dev, 8, *w_p.shape)
    mode = {"exact-tight": "exact"}.get(precision, precision)
    fit, key = {"exact": (rc.fitness_tiles, "K1-init"), "fast": (rc.fitness_tiles_fast, "K3-init"),
                "bf16": (rc.fitness_tiles_bf16, "K1-bf16-init")}[mode]
    (n,) = _counts(key)
    k = fit(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg, init=init)
    p = rc.fitness_tiles_plain(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg, mode=mode,
                               init=init)
    torch.testing.assert_close(k.sum(1), p.sum(1), rtol=1e-5 if mode == "bf16" else 5e-5, atol=0)
    assert torch.equal(k, fit(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg, init=init))
    assert _counts(key) == (n + 2,)
    # the init is read: without it the fitness changes
    assert not torch.equal(k, fit(cnt, idx, feats, tgt_p, w_p, n_tx, 64, 128, bg))
    if mode == "bf16":
        return
    canvas = rc.render_tiles_fast if mode == "fast" else rc.render_tiles
    kc = canvas(cnt, idx, feats, n_tx, 64, 128, bg, init=init)
    pc = rc.render_tiles_plain(cnt, idx, feats, n_tx, 64, 128, bg, mode=mode, init=init)
    torch.testing.assert_close(kc, pc, atol=2e-6, rtol=0)


def _grad_init_case(dev, B, N, H, W, seed=7):
    """K6's arguments from an init canvas on the port's gradient tiles:
    (cnt, idx, feats, n_tx, tile_h, tile_w), the init canvas and a cotangent
    in [-0.45, 0.45]."""
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, render_grad as rg

    th, tw = rg.GRAD_TILE_H, rg.GRAD_TILE_W
    g9 = codec.genome_to_renderer(genome.new_population(
        torch.Generator(device=dev).manual_seed(seed), B, N, H, W, device=dev))
    cnt, idx, _, n_tx, n_ty = pass_lists(g9, H, W, 3.0, "exact-tight", None, th, tw)
    feats = rg._splat_feats(codec.tighten_boxes_exact(codec.preprocess(g9, H, W, 3.0), 3.0))
    init = _init(dev, B, n_ty * th, n_tx * tw)
    g_img = (_init(dev, B, n_ty * th, n_tx * tw, seed=8) - 0.5).contiguous()
    return (cnt, idx, feats, n_tx, th, tw), init, g_img


def test_grad_kernel_with_init_matches_plain(dev):
    """K6 from an init canvas: grads per row within 1e-5 of the plain
    version's, d(init) = g * T_total within 1e-5 of its largest value."""
    from ggs_tpu_torch.ops import render_grad as rg

    (cnt, idx, feats, n_tx, th, tw), init, g_img = _grad_init_case(dev, 2, 600, 256, 256)
    bg = (1.0, 1.0, 1.0)
    g6, d6 = rg.bwd_tiles(cnt, idx, feats, g_img, n_tx, th, tw, bg, init=init)
    g6_p, d6_p = rg.bwd_tiles_plain(cnt, idx, feats, g_img, n_tx, th, tw, bg, init=init)
    assert float(_row_err(g6, g6_p).max()) <= 1e-5
    assert float((d6 - d6_p).abs().max() / d6_p.abs().max()) <= 1e-5
    g6b, d6b = rg.bwd_tiles(cnt, idx, feats, g_img, n_tx, th, tw, bg, init=init)
    assert torch.equal(g6, g6b) and torch.equal(d6, d6b)


# the memetic elite batch at run_ga's defaults: 8 x 128 tiles x 4 sub-tiles =
# 4,096 items, past the card's resident blocks (660 on an H100 SXM)
QUEUE_CASE = (8, 512, 512, 512)


def _items(dev, case, fused):
    """(items, resident blocks) of a gradient walk over case's lists."""
    from ggs_tpu_torch.ops import render_grad as rg

    cnt = case[0]
    return cnt.numel() * (case[4] // 4), rg._resident_blocks(fused, dev.index or 0)


def test_grad_kernel_queue_with_init_matches_plain(dev):
    """K6 with d(init) at more items than resident blocks, so the blocks
    take them from the queue: grads per row and d(init) within 1e-5 of the
    plain version's; one K6-queue count a launch; two launches equal in
    bits with a launch on another cotangent between them (a queue left
    unreset would leave that one's items past the first blocks unwalked)."""
    from ggs_tpu_torch.ops import render_grad as rg

    case, init, g_img = _grad_init_case(dev, *QUEUE_CASE)
    items, resident = _items(dev, case, False)
    assert items > resident
    bg = (1.0, 1.0, 1.0)
    g_other = (0.5 - _init(dev, QUEUE_CASE[0], *g_img.shape[2:], seed=9)).contiguous()
    n6, nq = _counts("K6", "K6-queue")
    g6, d6 = rg.bwd_tiles(*case[:3], g_img, *case[3:], bg, init=init)
    g6_p, d6_p = rg.bwd_tiles_plain(*case[:3], g_img, *case[3:], bg, init=init)
    assert float(_row_err(g6, g6_p).max()) <= 1e-5
    assert float((d6 - d6_p).abs().max() / d6_p.abs().max()) <= 1e-5
    go, do = rg.bwd_tiles(*case[:3], g_other, *case[3:], bg, init=init)
    go_p, do_p = rg.bwd_tiles_plain(*case[:3], g_other, *case[3:], bg, init=init)
    assert float(_row_err(go, go_p).max()) <= 1e-5
    assert float((do - do_p).abs().max() / do_p.abs().max()) <= 1e-5
    g6b, d6b = rg.bwd_tiles(*case[:3], g_img, *case[3:], bg, init=init)
    assert torch.equal(g6, g6b) and torch.equal(d6, d6b)
    assert _counts("K6", "K6-queue") == (n6 + 3, nq + 3)


def test_grad_kernel_queue_replays_in_a_graph(dev):
    """K6 with d(init) on the queue, captured once in a CUDA graph and
    replayed three times on alternating cotangents: each replay equal in
    bits to the eager launch on its cotangent, and the queue's counter 0
    after each, with no buffer made in the capture (so no fill node zeroes
    it: the kernel leaves it 0)."""
    from ggs_tpu_torch.ops import render_cuda as rc, render_grad as rg

    case, init, g_a = _grad_init_case(dev, *QUEUE_CASE)
    g_b = (0.5 - _init(dev, QUEUE_CASE[0], *g_a.shape[2:], seed=9)).contiguous()
    bg = (1.0, 1.0, 1.0)
    want = {k: rg.bwd_tiles(*case[:3], g, *case[3:], bg, init=init)
            for k, g in (("a", g_a), ("b", g_b))}
    g_in = g_a.clone()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):  # the stream's counter is made here, outside the capture
        rg.bwd_tiles(*case[:3], g_in, *case[3:], bg, init=init)
    torch.cuda.current_stream(dev).wait_stream(stream)
    queues = [v for (_, st), v in rc._TICKETS.items() if st == stream.cuda_stream]
    assert len(queues) == 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = rg.bwd_tiles(*case[:3], g_in, *case[3:], bg, init=init)
    assert [v for (_, st), v in rc._TICKETS.items() if st == stream.cuda_stream] == queues
    for k in ("a", "b", "a"):
        g_in.copy_(g_a if k == "a" else g_b)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[k][0]) and torch.equal(out[1], want[k][1])
        assert int(queues[0][0]) == 0


def test_grad_kernel_queue_only_past_the_blocks(dev):
    """K7 at run_grad's default lists (384 items, within the resident
    blocks) counts no queue; at the memetic batch (QUEUE_CASE) one a
    launch; both within 1e-5 a row of the plain version."""
    from ggs_tpu_torch.ops import mask, render_cuda as rc, render_grad as rg
    from ggs_tpu_torch.utils import io

    bg = (1.0, 1.0, 1.0)
    for (B, N, H, W), queued in (((1, 2000, 384, 512), 0), (QUEUE_CASE, 1)):
        case, _, _ = _grad_init_case(dev, B, N, H, W, seed=3)
        items, resident = _items(dev, case, True)
        assert (items > resident) == bool(queued)
        cnt, idx, feats, n_tx, th, tw = case
        tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device=dev)
        wm = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
        tgt_p, w_p = rc.pad_planes(tgt, wm, (cnt.shape[1] // n_tx) * th, n_tx * tw)
        n7, nq = _counts("K7", "K7-queue")
        num, g7 = rg.lossgrad_tiles(cnt, idx, feats, tgt_p, w_p, n_tx, th, tw, bg, 2.0)
        assert _counts("K7", "K7-queue") == (n7 + 1, nq + queued)
        num_p, g7_p = rg.lossgrad_tiles_plain(cnt, idx, feats, tgt_p, w_p, n_tx, th, tw, bg, 2.0)
        torch.testing.assert_close(num.sum(1), num_p.sum(1), rtol=5e-5, atol=0)
        assert float(_row_err(g7, g7_p).max()) <= 1e-5


def _scatter_case(dev, B, N, H, W, tile_h, precision, eps=None, coincident=0, seed=9):
    """K5's arguments at this shape: the tier's boxes (and the corner
    parameters under "fast"), `coincident` splats of candidate 0 on one spot
    (sigma 4 px at the canvas centre). At 4096 wide the splats are the
    canvas-4k configuration's (min_scale 1, max_scale 0.02)."""
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, render_cuda as rc, screen

    scales = (1.0, 0.02) if W >= 4096 else (3.0, 0.1)
    g = genome.new_population(torch.Generator(device=dev).manual_seed(seed), B, N, H, W, *scales,
                              device=dev)
    if coincident:
        g[0, :coincident] = torch.tensor([0.5, 0.5, 1.4, 1.4, 0.0, 128.0, 128.0, 128.0, 200.0],
                                         device=dev)
    p = screen.screen(codec.genome_to_renderer(g), H, W, 3.0, screen.tier(precision, eps))
    corner = rc._corner_params(p, eps) if eps is not None else None
    n_tx, n_ty = -(-W // 128), -(-H // tile_h)
    return dict(x0=p.x0, x1=p.x1, y0=p.y0, y1=p.y1, n_tx=n_tx, n_ty=n_ty, tile_h=tile_h,
                tile_w=128, cap=N, corner=corner), p


@pytest.mark.parametrize(
    "B,N,H,W,tile_h,precision,eps,coincident",
    [
        (4, 2000, 2048, 2048, 64, "exact-tight", None, 0),  # 512 tiles, no cull
        (4, 2000, 2048, 2048, 64, "fast", 2e-3, 0),  # the band cull, no overflow
        (1, 3000, 4096, 4096, 64, "fast", 8e-2, 0),  # 2,048 tiles
        (1, 2000, 1024, 1024, 16, "exact-tight", None, 0),  # the gradient tile
        (1, 1000, 4096, 4096, 64, "fast", 8e-2, 300),  # cap_s = 175 overflows
    ],
)
def test_scatter_kernel_matches_plain(dev, B, N, H, W, tile_h, precision, eps, coincident):
    """K5, from the boxes, against its plain route (scatter_args then
    bin_splats_scatter_plain): idx over its whole width, cnt and the largest
    true count equal; without the cull also equal to bin_splats_dense; the
    same bits twice; one count per call, and one band stage each."""
    from ggs_tpu_torch.ops import render_cuda as rc

    args, p = _scatter_case(dev, B, N, H, W, tile_h, precision, eps, coincident)
    n, nb = _counts("K5", "K5-band")
    idx, cnt, tmax = rc.bin_splats_scatter(**args)
    plain = rc.scatter_args(**args)
    idx_p, cnt_p, tmax_p = rc.bin_splats_scatter_plain(**plain)
    assert torch.equal(idx, idx_p) and torch.equal(cnt, cnt_p) and int(tmax) == int(tmax_p)
    assert _counts("K5", "K5-band") == (n + 1, nb + 1)
    again = rc.bin_splats_scatter(**args)
    assert torch.equal(again[0], idx) and torch.equal(again[1], cnt)
    overflow = plain["fallback"] is not None and int(tmax) > plain["cap_s"]
    assert overflow == bool(coincident)
    if eps is None:
        di, dc = rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, args["n_tx"], args["n_ty"], tile_h,
                                     128, N)
        assert torch.equal(idx, di) and torch.equal(cnt, dc)


@pytest.mark.parametrize(
    "B,N,n,H,W,tile_h,pad",
    [
        (32, 512, 512, 384, 512, 64, 8),  # ga512-p32
        (512, 512, 512, 384, 512, 64, 8),  # ga512-p512
        (1024, 10_000, 5_000, 1024, 1024, 64, 8),  # ga1024-p4096's passes
        (1, 2000, 2000, 384, 512, 16, 40),  # adam512-n2000
        (1, 10_000, 5_000, 1024, 1024, 16, 40),  # adam1024-n10k's passes
    ],
)
def test_exact_bin_splats_takes_k5_and_equals_dense(dev, B, N, n, H, W, tile_h, pad):
    """bin_splats on the card at the benchmark cells' shapes (exact-tight,
    the first pass of n splats): the lists equal bin_splats_dense's as
    integers (idx over its whole width, cnt), and the call counts one K5
    launch and its route "bin.k5", and no dense one."""
    from ggs_tpu_torch.ops import render_cuda as rc

    args, _ = _scatter_case(dev, B, N, H, W, tile_h, "exact-tight")
    box = tuple(args[k][:, :n] for k in ("x0", "x1", "y0", "y1"))
    geo = (args["n_tx"], args["n_ty"], tile_h, 128, n)
    keys = ("bin.dense", "bin.k5", "K5")
    before = _counts(*keys)
    idx, cnt = rc.bin_splats(*box, *geo, None, pad_slots=pad)
    assert tuple(a - b for a, b in zip(_counts(*keys), before)) == (0, 1, 1)
    di, dc = rc.bin_splats_dense(*box, *geo)
    assert idx.shape == di.shape == (B, geo[0] * geo[1], n)
    assert torch.equal(idx, di) and torch.equal(cnt, dc)
    assert int(cnt.max()) > 0


def test_scatter_wrapper_rejects_bad_arguments(dev, monkeypatch):
    from ggs_tpu_torch.ops import render_cuda as rc

    args, _ = _scatter_case(dev, 1, 200, 1024, 1024, 16, "fast", 8e-2)
    with pytest.raises(TypeError):
        rc.bin_splats_scatter(**dict(args, x0=args["x0"].long()))
    with pytest.raises(ValueError):  # a box row whose last stride is not 1
        rc.bin_splats_scatter(**dict(args, y1=args["y1"].repeat(1, 2)[:, ::2]))
    with pytest.raises(ValueError):
        corner = (args["corner"][0][:, :-1],) + tuple(args["corner"][1:])
        rc.bin_splats_scatter(**dict(args, corner=corner))
    monkeypatch.setattr(rc, "SCATTER_BUDGET", 1024)  # cap_s = 3: the rules bin densely
    with pytest.raises(ValueError):
        rc.bin_splats_scatter(**args)
