"""``step_idle_pct``: the share of the measured window in which the card
ran nothing, as 1 - (the card's busy time a traced step: the union of its
kernel, copy and fill intervals, from the profiler) / (the measured
window's time a step, host clock).  For cells whose pace the host sets:
there the profiler's own cost on the host (about 1 ms a step in
``cudaGraphLaunch``) lengthens a traced step but not the card's work in
it, so the traced window's share (``device_idle_pct``, and the line's
``device.busy_s / device.window_s``) reads the profiler.  The profiler
lengthens the card's own work by about 1%, so where the card keeps the
pace this share reads within about a point of 0, below it as often as
above."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or run.steps <= 0:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.steps) / (run.window_s / run.steps))
