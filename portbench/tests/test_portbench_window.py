"""The timed window's rate arithmetic, on a fake clock."""
from portbench.harness import timed_window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _blocks(clock, durations):
    it = iter(durations)

    def block():
        clock.t += next(it)

    return block


def test_whole_blocks_until_the_seconds_have_passed():
    clock = FakeClock()
    units, secs, n = timed_window(_blocks(clock, [0.3] * 10), 50, 1.0, clock)
    assert n == 4  # 0.9 s after three blocks: a fourth runs whole
    assert units == 200
    assert abs(secs - 1.2) < 1e-12
    assert abs(units / secs - 200 / 1.2) < 1e-9


def test_a_stall_inside_the_window_lowers_the_rate():
    steady, stalled = FakeClock(), FakeClock()
    u1, s1, _ = timed_window(_blocks(steady, [0.25] * 8), 50, 1.0, steady)
    u2, s2, _ = timed_window(_blocks(stalled, [0.25, 0.25, 0.9, 0.25, 0.25]), 50, 1.0, stalled)
    assert u2 / s2 < u1 / s1
    # the rate is all the work over all the time, not a median of blocks
    assert abs(u2 / s2 - 150 / 1.4) < 1e-9
