"""``input_wait_pct``: host time in ``next(feed)`` (the Prefetcher) as a
share of the window, timed as ``train/loop.py _train`` times it."""


def read(run):
    return 100.0 * run.wait_s / run.window_s
