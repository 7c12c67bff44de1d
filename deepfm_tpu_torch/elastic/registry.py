"""Device availability, the signal that makes the grid's shape a runtime
variable: the port's counterpart of ``deepfm_tpu/elastic/registry.py``.

Two registries behind one protocol: ``devices()`` (the live devices in a
stable order), ``epoch`` (bumped on every membership change; the train
loop polls it between batches) and ``snapshot()`` (both at once).

* :class:`VirtualDeviceRegistry`: a scriptable registry over a fixed
  list; ``fail(...)``/``restore(...)`` simulate a loss and a regain.
* :class:`LiveDeviceRegistry`: polls a backend, a callable that returns
  the live devices, with JAX's debounce (``elastic.registry_debounce_
  polls``): the same changed reading must repeat that many consecutive
  polls before the epoch moves.  A backend that raises counts as an empty
  view, as JAX's ``jax.devices()`` failing does.

A device here is a :class:`RankDevice`: the launch index a launcher gives
a rank process once (its ``.id``), and the card it runs on.  JAX's
``jax.devices()`` is the global list every process sees; the port's
counterpart is :class:`DeviceBoard`, the list of live device ids under one
key of the ranks' rendezvous store, which every rank reads.  The
platform (an operator, a chaos drill, ``chip_smoke.py``) writes it: a
device taken off the board is advance notice to its rank to drain and
leave.  :func:`board_backend` is a rank's view: the board, without its
own id once its card stops answering (:func:`card_probe`).  A world of
one process has no board: :func:`own_card_backend` is its view.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, NamedTuple, Sequence

import torch


class RankDevice(NamedTuple):
    """One rank's device: ``id`` is the launch index (stable for the
    process's life), ``card`` the torch device it computes on."""

    id: int
    card: str = "cpu"


class VirtualDeviceRegistry:
    """Deterministic, scriptable availability over a fixed device list.
    ``fail``/``restore`` take indices into the base list; a restored
    device returns to its place, so a shrink-then-grow round trip rebuilds
    the same layout.  Thread-safe."""

    def __init__(self, devices: Sequence):
        self._base = tuple(devices)
        if not self._base:
            raise ValueError("registry needs at least one device")
        self._failed: set[int] = set()
        self._lock = threading.Lock()
        self._epoch = 0

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def devices(self) -> tuple:
        with self._lock:
            return tuple(d for i, d in enumerate(self._base) if i not in self._failed)

    def fail(self, *indices: int) -> int:
        """Mark devices unavailable; returns the new epoch.  Failing an
        already-failed device is no membership change (no epoch bump)."""
        with self._lock:
            before = set(self._failed)
            for i in indices:
                if not 0 <= i < len(self._base):
                    raise IndexError(f"device index {i} out of range [0, {len(self._base)})")
                self._failed.add(i)
            if self._failed != before:
                self._epoch += 1
            return self._epoch

    def restore(self, *indices: int) -> int:
        """Return devices to availability; no bump for a device never failed."""
        with self._lock:
            before = set(self._failed)
            for i in indices:
                self._failed.discard(i)
            if self._failed != before:
                self._epoch += 1
            return self._epoch

    def snapshot(self) -> tuple[int, tuple]:
        """The ``(epoch, devices)`` pair, read atomically."""
        with self._lock:
            return self._epoch, tuple(d for i, d in enumerate(self._base)
                                      if i not in self._failed)


class LiveDeviceRegistry:
    """A backend's liveness reduced to the epoch/devices protocol.  Each
    :meth:`poll` calls ``backend()``; a changed reading (other ids, or the
    call raising) bumps the epoch once it held ``debounce_polls``
    consecutive polls, and ``devices()`` keeps the last good list while
    the backend fails."""

    def __init__(self, backend: Callable[[], Sequence], *, debounce_polls: int = 2):
        if debounce_polls < 1:
            raise ValueError(f"debounce_polls must be >= 1, got {debounce_polls}")
        self._backend = backend
        self._debounce = int(debounce_polls)
        self._lock = threading.Lock()
        self._epoch = 0
        self._last = tuple(backend())
        self._last_ids = tuple(d.id for d in self._last)
        self._pending_ids: tuple | None = None
        self._pending_count = 0

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def devices(self) -> tuple:
        with self._lock:
            return self._last

    def poll(self) -> int:
        """Re-read the backend; bump the epoch once the same changed
        reading held ``debounce_polls`` consecutive polls."""
        try:
            live = tuple(self._backend())
            ids = tuple(d.id for d in live)
        # da:allow[swallowed-exception] a failing device query IS the signal: it reads as an empty view
        except Exception:
            live, ids = (), ()
        with self._lock:
            if ids == self._last_ids:
                self._pending_ids, self._pending_count = None, 0
                return self._epoch
            if ids == self._pending_ids:
                self._pending_count += 1
            else:
                self._pending_ids, self._pending_count = ids, 1
            if self._pending_count >= self._debounce:
                self._epoch += 1
                if live:  # keep the last good list while the backend fails
                    self._last = live
                self._last_ids = ids
                self._pending_ids, self._pending_count = None, 0
            return self._epoch

    def snapshot(self) -> tuple[int, tuple]:
        self.poll()
        with self._lock:
            return self._epoch, self._last


def card_probe(card: torch.device) -> bool:
    """Whether this process's card answers: a CUDA query on it (the CPU
    always answers)."""
    if card.type != "cuda":
        return True
    torch.cuda.mem_get_info(card)
    return True


def own_card_backend(device_id: int, card: torch.device) -> Callable[[], tuple]:
    """A one-process world's view: its own device while its card answers
    (a failing probe raises, which the registry reads as an empty view)."""
    dev = RankDevice(int(device_id), str(card))

    def backend() -> tuple:
        card_probe(card)
        return (dev,)

    return backend


class DeviceBoard:
    """The list of live device ids under ``key`` of a ``torch.distributed``
    store (the ranks' rendezvous store), as JSON.  Every rank reads the
    same list; :meth:`add`/:meth:`remove` are compare-and-set loops."""

    def __init__(self, store, key: str = "elastic/devices"):
        self.store = store
        self.key = key

    def read(self) -> tuple[int, ...]:
        if not self.store.check([self.key]):
            return ()
        return tuple(json.loads(self.store.get(self.key).decode()))

    def write(self, ids: Sequence[int]) -> None:
        self.store.set(self.key, json.dumps(sorted(int(i) for i in ids)))

    def _update(self, fn) -> tuple[int, ...]:
        while True:
            raw = self.store.get(self.key) if self.store.check([self.key]) else b""
            ids = tuple(json.loads(raw.decode())) if raw else ()
            new = json.dumps(sorted(fn(set(ids))))
            got = self.store.compare_set(self.key, raw.decode() if raw else "", new)
            if got.decode() == new:
                return tuple(json.loads(new))

    def add(self, *ids: int) -> tuple[int, ...]:
        return self._update(lambda s: s | {int(i) for i in ids})

    def remove(self, *ids: int) -> tuple[int, ...]:
        return self._update(lambda s: s - {int(i) for i in ids})


def board_backend(board: DeviceBoard, device_id: int, card: torch.device
                  ) -> Callable[[], tuple]:
    """A rank's view in a coordinated world: every id on the board, without
    its own once its card stops answering."""
    card_name = str(card)

    def backend() -> tuple:
        ids = board.read()
        try:
            ok = card_probe(card)
        # da:allow[swallowed-exception] a card that stopped answering makes the probe raise; that IS the signal
        except Exception:
            ok = False
        return tuple(RankDevice(i, card_name) for i in ids if ok or i != device_id)

    return backend
