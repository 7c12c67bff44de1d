"""``setup_s``: process start to the first timed step (host clock): the
imports, the card's start, the kernels' build or load, the ring, the
weights, the warm-up steps with the graph capture and the compared
steps."""


def read(run):
    return run.setup_s
