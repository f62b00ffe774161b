"""Seeded numpy inputs shared by the port's cross-check tests
(tests/test_torch_*.py): both packages receive the same float32 arrays;
`pass_lists`, one pass's walk inputs through the port's own steps;
`one_torch_thread`, the autouse fixture those files import; and `chained`,
the fixture that lowers the pass size in both packages."""
import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Runs a test module's torch CPU ops on one intra-op thread. The suite
    runs six worker processes on the machine's cores, and with a thread pool
    each the many small ops these tests make oversubscribe them: six
    concurrent copies of tests/test_torch_runners_sa.py took 514 s with the
    default pool and 17 s with one thread (8 cores); alone, either takes
    ~10 s. The thread count changes no result beyond the summation order of
    CPU reductions, which every tolerance here covers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def chained(monkeypatch):
    """The pass size lowered to 7 splats in both packages
    (render_pallas._MAX_SMEM_SPLATS, render_cuda.MAX_SPLATS), so a small N
    runs chained passes; JAX's jitted renderers are cleared on both sides."""
    from ggs_tpu.ops import render_pallas as rp
    from ggs_tpu_torch.ops import render_cuda as rc

    def clear():
        rp.render_pallas.clear_cache()
        rp.fitness_pallas.clear_cache()

    monkeypatch.setattr(rp, "_MAX_SMEM_SPLATS", 7)
    monkeypatch.setattr(rc, "MAX_SPLATS", 7)
    clear()
    yield
    clear()  # before monkeypatch restores the sizes: the next trace sees them


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


def pass_lists(g9, H, W, k_sigma, precision, bin_capacity, tile_h, tile_w, cull_eps=None,
               corner_cull=False, fitness_route=False):
    """Renderer genomes (torch) -> (cnt, idx, feats, n_tx, n_ty) of one pass
    over all of them, as render_cuda's entry points build it: with
    fitness_route under "fast", fast fitness's K4 route (`_k4_pass`); else
    the tier's boxes (`_screen`) binned by `_pass_lists`."""
    from ggs_tpu_torch.ops import render_cuda as rc

    g9 = rc._genomes(g9)
    n_tx, n_ty = -(-W // tile_w), -(-H // tile_h)
    if fitness_route and precision == "fast":
        cnt, idx, feats = rc._k4_pass(g9, H, W, k_sigma, bin_capacity, tile_h, tile_w, cull_eps,
                                      corner_cull)
    else:
        p = rc._screen(g9, H, W, k_sigma, precision, cull_eps)
        cnt, idx, feats = rc._pass_lists(p, n_tx, n_ty, tile_h, tile_w, bin_capacity, precision,
                                         rc._corner_eps(precision, corner_cull, cull_eps))
    return cnt, idx, feats, n_tx, n_ty
