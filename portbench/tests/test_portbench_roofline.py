"""The roofline's work counted from genomes, against hand counts."""
import math

import torch

from portbench import reference, roofline


def _genome(x, y, sigma_x, sigma_y, W, H):
    """One splat at pixel (x, y), axis-aligned, opaque."""
    return torch.tensor([[x / (W - 1), y / (H - 1), math.log(sigma_x), math.log(sigma_y),
                          0.0, 10.0, 20.0, 30.0, 255.0]], dtype=torch.float32)


def _hand(box, tile_h):
    x0, x1, y0, y1 = box
    return (x1 - x0 + 1) * (y1 - y0 + 1), (x1 - x0 + 1) * (y1 // tile_h - y0 // tile_h + 1)


def test_pair_counts_of_a_box_across_tile_rows():
    H = W = 65
    g = _genome(20.0, 30.0, 2.0, 3.0, W, H)[None]  # [1, 1, 9]
    box = reference.screen(g, H, W).box[0, 0].tolist()
    # the exact-tight 3-sigma box: +-6 columns and +-9 rows about the centre
    assert all(abs(a - b) <= 1 for a, b in zip(box, (14, 26, 21, 39)))
    assert box[2] // 16 == 1 and box[3] // 16 == 2  # two tile rows of 16
    assert roofline.pair_counts(g, H, W, tile_h=16) == _hand(box, 16)


def test_pair_counts_clip_to_the_canvas_and_sum_over_candidates():
    H, W = 33, 49
    g = torch.stack([_genome(0.0, 0.0, 2.0, 2.0, W, H), _genome(48.0, 16.0, 1.0, 4.0, W, H)])
    boxes = reference.screen(g, H, W).box[:, 0].tolist()
    assert boxes[0][0] == 0 and boxes[0][2] == 0  # clipped at the corner
    assert boxes[1][1] == 48  # clipped at the right edge
    want = [_hand(b, 8) for b in boxes]
    assert roofline.pair_counts(g, H, W, tile_h=8) == (sum(w[0] for w in want),
                                                       sum(w[1] for w in want))


def test_least_time_takes_the_larger_bound():
    ops = 21e9 + 5e7 + 16 * 384 * 512 * 32
    t = roofline.forward_least_s(1e9, 1e7, 32, 1, 384, 512, 512)
    assert t == ops / roofline.PEAK_FP32_FLOPS  # operations bound it
    nbytes = 10 * (36 + 4) + 10 * 16 * 4096 * 4096
    t = roofline.forward_least_s(0.0, 0.0, 10, 10, 4096, 4096, 1)
    assert t == nbytes / roofline.PEAK_BYTES_PER_S  # bytes bound it
