"""A Pipe-mode channel's writer: a thread that fills a FIFO with a payload,
in the role SageMaker's Pipe mode plays for a training container, with a
deadline on every wait.

It opens the FIFO by a non-blocking open and a poll (so a channel nobody
opens never holds it) and writes through ``select`` (so a reader that
stops reading never holds it).  ``forever`` repeats the payload until the
reader closes its end: a channel that never closes.  Past its deadline, and
until :meth:`ChannelWriter.close`, it opens and closes the FIFO whenever a
reader waits on it, so a late reader sees EOF instead of waiting forever.
Used by ``chip_smoke.py``'s stream phase and the stream-mode tests.
"""

from __future__ import annotations

import contextlib
import errno
import os
import select
import threading
import time


class ChannelWriter:
    """Fill the FIFO ``path`` (made if missing) with ``payload`` on a
    thread; ``written`` counts the bytes, ``reader_closed`` says the reader
    closed its end first, ``error`` holds what stopped the writer."""

    POLL_SECS = 0.02

    def __init__(self, path, payload: bytes, *, forever: bool = False,
                 deadline_s: float = 60.0):
        self.path, self.payload, self.forever = str(path), payload, forever
        if not os.path.exists(self.path):
            os.mkfifo(self.path)
        self.deadline = time.monotonic() + deadline_s
        self.written, self.reader_closed = 0, False
        self.error: BaseException | None = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, name="channel-writer", daemon=True)
        self._thread.start()

    def _left(self) -> float:
        left = self.deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"{self.path}: the channel writer's deadline passed")
        return left

    def _open(self) -> int:
        while not self._done.is_set():
            try:
                return os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
            except OSError as e:
                if e.errno != errno.ENXIO:  # ENXIO: no reader yet
                    raise
            time.sleep(min(self.POLL_SECS, self._left()))
        raise TimeoutError(f"{self.path}: closed before a reader opened it")

    def _run(self) -> None:
        try:
            fd = self._open()
            try:
                while True:
                    view = memoryview(self.payload)
                    while view:
                        if self._done.is_set():
                            raise TimeoutError(f"{self.path}: closed while writing")
                        if not select.select([], [fd], [], min(0.1, self._left()))[1]:
                            continue
                        try:
                            n = os.write(fd, view[:1 << 16])
                        except BlockingIOError:
                            continue
                        view, self.written = view[n:], self.written + n
                    if not self.forever:
                        return
            finally:
                os.close(fd)
        except BrokenPipeError:
            self.reader_closed = True
        except BaseException as e:  # raised by join()
            self.error = e
            while not self._done.wait(0.05):  # release a late reader
                with contextlib.suppress(OSError):
                    os.close(os.open(self.path, os.O_WRONLY | os.O_NONBLOCK))

    def join(self, timeout: float | None = None) -> "ChannelWriter":
        """Wait for the writer (at most ``timeout`` s, by default until 5 s
        past its deadline); raise, after :meth:`close`, if it failed or is
        still writing."""
        if timeout is None:
            timeout = max(0.0, self.deadline - time.monotonic()) + 5.0
        self._thread.join(timeout)
        if self._thread.is_alive() or self.error is not None:
            self.close()
            if self.error is not None:
                raise self.error
            raise TimeoutError(f"{self.path}: the channel writer is still writing")
        return self

    def close(self) -> None:
        """Stop the writer (and its release of late readers); never raises."""
        self._done.set()
        self._thread.join(timeout=5)

    def __enter__(self) -> "ChannelWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
