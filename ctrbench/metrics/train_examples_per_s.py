"""``train_examples_per_s``: every example trained in the window over the
window's seconds (host clock; the window ends with a synchronize)."""


def read(run):
    return run.examples / run.window_s
