"""Faults planted under the timed path for the harness's tests: each is a
module-level function returning a context manager, which the harness
enters around the program's run."""

import contextlib


@contextlib.contextmanager
def _patched(name: str, make):
    from deepfm_tpu_torch.parallel import spmd

    real = getattr(spmd, name)
    setattr(spmd, name, make(real))
    try:
        yield
    finally:
        setattr(spmd, name, real)


def unchanged():
    """A step that returns its state unchanged: the update is undone."""
    from deepfm_tpu_torch.parallel import spmd

    def make(real):
        def step(state, batch, ctx, **kw):
            local = spmd.local_state(state)
            saved = {"model": {k: v.clone() for k, v in local["model"].items()},
                     "optimizer": {"count": local["optimizer"]["count"], "slots": {
                         n: {s: t.clone() for s, t in d.items()}
                         for n, d in local["optimizer"]["slots"].items()}},
                     "lazy": None}
            count = state.step
            metrics = real(state, batch, ctx, **kw)
            spmd.load_local_state(state, saved)
            state.step = count
            return metrics
        return step

    return _patched("train_step", make)


def half_batch():
    """Half of the batch left out, the mean taken over the rest."""
    def make(real):
        def step(state, batch, ctx, **kw):
            n = batch["label"].shape[0] // 2
            return real(state, {k: v[:n] for k, v in batch.items()}, ctx, **kw)
        return step

    return _patched("train_step", make)

