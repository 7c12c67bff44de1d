"""``device_idle_pct``: 1 - (the union of the device's kernel, copy and
fill intervals over the traced window's length), from the profiler's
timeline.  The profiler's own cost on the host lengthens a host-paced
window, so this share is for cells whose pace the card sets;
``step_idle_pct`` is for the others."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
