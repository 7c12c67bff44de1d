"""The arm of a host branch that a collective is issued in.

JAX takes the grid step's two data-dependent branches, the exchange's
capacity-overflow fallback (parallel/embedding.py ``exchange_rows``) and
the lazy step's unique pack (parallel/spmd.py ``lazy_train_step``), with
``lax.cond``: their collectives sit in the arms of a ``stablehlo.case``,
and JAX's trace audit reads which arm holds each one.  The port takes them
with a host ``if``; each arm runs under :class:`arm`, and the collective
recorder (analysis/collectives.py) stamps every call with the arm it was
issued in.  Two more arms say what a data-group all-reduce carries, for
the ZeRO contract (analysis/trace_audit.py ``check_zero_collectives``):
``sync.stats``, parallel/spmd.py ``pmean_grads``'s buffer when it holds no
gradient (the BN statistics, the metrics and the flags of the ZeRO step),
and ``zero.ineligible``, the replicated update of a leaf without a ZeRO
window (train/optimizer.py ``ZeroOptimizer.step``).

:class:`arm` does nothing unless a recorder is watching (:func:`watch`),
so it costs an attribute read a branch and changes no number of a step.
An ``autograd.Function`` whose backward issues collectives keeps
:func:`current_arm` of its forward and enters it again in its backward,
which runs after the forward's arm has closed (and on the card, on
autograd's own thread).
"""

from __future__ import annotations

import contextvars

_ARM: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "deepfm_collective_arm", default=None)
_watchers = 0


def watch(on: bool) -> None:
    """A recorder starts (``True``) or stops (``False``) reading arms."""
    global _watchers
    _watchers += 1 if on else -1


def current_arm() -> str | None:
    """The arm this thread is in (None: the step's main line, or nobody
    watching)."""
    return _ARM.get() if _watchers else None


class arm:
    """``with arm("exchange.fallback"): ...``: the collectives issued inside
    belong to that arm of a host branch."""

    __slots__ = ("name", "_token")

    def __init__(self, name: str | None):
        self.name = name
        self._token = None

    def __enter__(self) -> "arm":
        if _watchers:
            self._token = _ARM.set(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _ARM.reset(self._token)
            self._token = None
