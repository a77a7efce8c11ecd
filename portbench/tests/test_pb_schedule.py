"""The major cell's schedule, and its mean, over a window that ends in
the middle of a unit."""

import pytest

from portbench.systems.major import major_ms, schedule


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.mark.parametrize("durations,starts", [
    # Every unit shorter than the period: one start every 2 s, the
    # first a period after the window opens.
    ([0.5] * 6, [102, 104, 106, 108]),
    # A unit longer than the period delays the next, which then runs
    # at once; the schedule catches up after.
    ([2.5, 0.5, 0.5, 0.5, 0.5, 0.5], [102, 104.5, 106, 108]),
])
def test_schedule(durations, starts):
    clock = Clock()
    it = iter(durations)

    def unit(i):
        clock.sleep(next(it))
        return i

    seen = []
    units = schedule(clock(), 10.0, 2.0, unit, seen.append,
                     clock=clock, sleep=clock.sleep)
    assert [round(a, 6) for a, _ in units] == starts
    assert seen == list(range(len(starts)))


def test_window_ending_mid_unit_counts_the_whole_unit():
    clock = Clock()
    durations = iter([0.5, 0.5, 0.5, 0.5, 3.0])

    def unit(i):
        clock.sleep(next(durations))

    units = schedule(clock(), 11.0, 2.0, unit, lambda _: None,
                     clock=clock, sleep=clock.sleep)
    # Units start at 2, 4, 6, 8 and 10 s; the one started at 10 s ends
    # at 13 s, past the 11 s window, and counts whole.
    assert len(units) == 5
    assert units[-1][1] == pytest.approx(113.0)
    assert major_ms(units) == pytest.approx(1e3 * (4 * 0.5 + 3.0) / 5)
