"""The plain reference against a tiny canvas composited by hand."""
import math

import torch

from portbench import reference


def _splat(x, y, sx, sy, rgb, alpha, W, H):
    return [x / (W - 1), y / (H - 1), math.log(sx), math.log(sy), 0.0, *rgb, alpha]


def _by_hand(g, H, W):
    """Painter order over a white canvas, each splat over its own box, in
    float64."""
    s = reference.screen(g[None], H, W)
    C = torch.ones(3, H, W, dtype=torch.float64)
    for n in range(g.shape[0]):
        x0, x1, y0, y1 = s.box[0, n].tolist()
        for y in range(y0, y1 + 1):
            for x in range(x0, x1 + 1):
                dx, dy = x - float(s.cx[0, n]), y - float(s.cy[0, n])
                q = (float(s.nsxx[0, n]) * dx * dx + float(s.nsxy[0, n]) * dx * dy
                     + float(s.nsyy[0, n]) * dy * dy)
                f = math.exp(q) * float(s.a[0, n])
                C[:, y, x] = (1 - f) * C[:, y, x] + f * s.col[0, n].double()
    return C.clamp(0, 1)


def test_canvas_and_energy_against_a_hand_composite():
    H, W = 12, 16
    g = torch.tensor([_splat(5.0, 4.0, 1.5, 2.0, (255.0, 0.0, 0.0), 200.0, W, H),
                      _splat(7.0, 6.0, 2.5, 1.2, (0.0, 128.0, 255.0), 255.0, W, H),
                      _splat(15.0, 11.0, 1.0, 1.0, (10.0, 250.0, 10.0), 90.0, W, H)],
                     dtype=torch.float32)
    hand = _by_hand(g, H, W)
    got = reference.canvases(g[None], H, W)[0]
    assert torch.allclose(got.double(), hand, atol=1e-6, rtol=0)
    # the second splat covers the first where they overlap: painter order
    assert got[2, 6, 7] > got[0, 6, 7]
    target = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(1))
    mask = torch.rand(H, W, generator=torch.Generator().manual_seed(2))
    want = (((hand - target.permute(2, 0, 1).double()) ** 2).sum(0) * mask).sum() / mask.sum()
    e = reference.energies(g[None], target, mask, H, W)[0]
    assert abs(float(e) - float(want)) <= 1e-6 * float(want)


def test_gradient_against_finite_differences():
    H, W = 10, 12
    g = torch.tensor([_splat(4.0, 5.0, 2.0, 1.5, (200.0, 30.0, 60.0), 180.0, W, H),
                      _splat(6.5, 4.5, 1.8, 2.2, (20.0, 220.0, 90.0), 150.0, W, H)],
                     dtype=torch.float32)
    target = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(3))
    mask = torch.ones(H, W)
    e, grad = reference.value_and_grad(g, target, mask, H, W)
    # colour and alpha genes: smooth away from the clip bounds and the box edges
    for n, col in ((0, 5), (1, 6), (0, 8), (1, 8)):
        step = 0.5
        hi, lo = g.clone(), g.clone()
        hi[n, col] += step
        lo[n, col] -= step
        fd = (float(reference.energies(hi[None].double().float(), target, mask, H, W)[0])
              - float(reference.energies(lo[None], target, mask, H, W)[0])) / (2 * step)
        assert abs(fd - float(grad[n, col])) <= 1e-3 * abs(fd) + 1e-7
    assert abs(e - float(reference.energies(g[None], target, mask, H, W)[0])) <= 1e-6 * e
    # the same energy and gradient over tiles of another size
    e1, grad1 = reference.value_and_grad(g, target, mask, H, W, tile=(3, 5))
    assert abs(e1 - e) <= 1e-6 * e
    assert torch.allclose(grad1, grad, rtol=1e-5, atol=1e-8)
