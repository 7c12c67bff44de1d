"""Object-store client over the S3 wire subset: the port's copy of
``deepfm_tpu/data/object_store.py``.

* :class:`HttpObjectStore` speaks ``GET`` (with ``Range``), ``PUT``,
  ``HEAD``, ``DELETE`` and ``ListObjectsV2`` (``?list-type=2&prefix=``
  XML, with continuation-token pagination) on stdlib ``urllib``: real S3,
  GCS's XML API, MinIO-style servers, and the port's test double
  (``deepfm_tpu_torch.utils.dev_object_store``).
* Every verb runs under the port's ``utils/retry.py RetryPolicy``:
  connection errors and 5xx/429 are transient and retried, any other 4xx
  fails at once (:class:`ObjectStoreError` carries the verdict).
* :class:`ResumingStream` re-issues a ranged GET from the exact byte
  offset when a connection drops mid-body (a dropped body reads as a clean
  EOF under sized reads otherwise).
* :class:`FifoBridge` streams one object into a named FIFO, so the C++
  record reader (``native/``), which takes paths, decodes remote records
  without spooling them to disk; :func:`open_source` opens a local path
  or an object URL for streaming reads.

URL convention: ``http(s)://host[:port]/bucket/key...``: the first path
segment is the bucket, the rest the key (S3 path-style addressing).  Local
paths are untouched by this module.
"""

from __future__ import annotations

import http.client
import os
import threading
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import BinaryIO

_SCHEMES = ("http://", "https://")


def is_url(path: object) -> bool:
    return isinstance(path, str) and path.startswith(_SCHEMES)


def _split_bucket(url: str) -> tuple[str, str, str]:
    """``http://host/bucket/a/b`` -> (``http://host``, ``bucket``, ``a/b``)."""
    p = urllib.parse.urlsplit(url)
    path = p.path.lstrip("/")
    bucket, _, key = path.partition("/")
    if not bucket:
        raise ValueError(f"object URL needs a /bucket/ path segment: {url!r}")
    return f"{p.scheme}://{p.netloc}", bucket, key


def join_url(base: str, *parts: str) -> str:
    """posix-join path parts onto a URL base (no normalization surprises)."""
    out = base.rstrip("/")
    for part in parts:
        out = out + "/" + part.strip("/")
    return out


class ObjectStoreError(IOError):
    """Store-layer failure with enough structure to classify it.

    ``status`` is the HTTP status code when one was received (None for
    connection-level failures), ``url`` the object URL, and ``retryable``
    the transient/permanent verdict: connection errors and 5xx/429 are
    transient (retry them), any other 4xx is a caller/state error that a
    retry cannot fix (fail fast)."""

    def __init__(self, msg: str, *, status: int | None = None,
                 url: str | None = None, retryable: bool = True):
        super().__init__(msg)
        self.status = status
        self.url = url
        self.retryable = retryable


def _retryable_status(code: int) -> bool:
    return code >= 500 or code == 429


def _is_transient(exc: BaseException) -> bool:
    """Retry verdict for a failed store operation: structured store errors
    carry it; bare socket/HTTP-protocol errors mid-body are transient."""
    if isinstance(exc, ObjectStoreError):
        return exc.retryable
    return isinstance(exc, (OSError, http.client.HTTPException))


def _default_retry_policy():
    from ..utils.retry import RetryPolicy

    return RetryPolicy(max_attempts=4, base_delay_secs=0.1,
                       max_delay_secs=2.0)


class HttpObjectStore:
    """Stateless S3-wire-subset client.  One instance is shared freely
    across threads (urllib openers are thread-safe).

    Every verb runs under ``retry`` (bounded attempts, full-jitter
    exponential backoff — utils/retry.py): connection errors and 5xx/429
    responses re-attempt, other 4xx fail fast.  Blind re-execution is safe
    on this API surface: GET/HEAD/LIST are reads, DELETE is idempotent, and
    PUT always carries the FULL object (the S3 model — no partial writes),
    so a re-PUT converges to the same committed object."""

    def __init__(self, *, timeout: float = 60.0, retry=None):
        self._timeout = timeout
        self._retry = _default_retry_policy() if retry is None else retry

    # -- plumbing ----------------------------------------------------------
    def _request(self, method: str, url: str, *, data: bytes | None = None,
                 headers: dict | None = None):
        """One attempt, no retry — classification happens here."""
        req = urllib.request.Request(
            url, data=data, method=method, headers=headers or {})
        try:
            return urllib.request.urlopen(req, timeout=self._timeout)
        except urllib.error.HTTPError as e:
            raise ObjectStoreError(
                f"{method} {url} -> HTTP {e.code} {e.reason}",
                status=e.code, url=url,
                retryable=_retryable_status(e.code)) from e
        except urllib.error.URLError as e:
            raise ObjectStoreError(f"{method} {url} -> {e.reason}",
                                   url=url, retryable=True) from e

    def _retrying(self, fn):
        return self._retry.call(fn, classify=_is_transient)

    # -- data path ---------------------------------------------------------
    def open_read(self, url: str, *, offset: int = 0,
                  length: int | None = None) -> BinaryIO:
        """Raw streaming GET; ``offset``/``length`` issue a ``Range`` read
        (``length`` bounds the span to ``[offset, offset+length)`` — the
        cold-tier row-page path, which must never stream a whole segment).

        CAUTION: a connection dropped mid-body surfaces as a CLEAN EOF
        under sized reads (urllib does not raise IncompleteRead for
        ``read(n)``), i.e. silent truncation.  Data-plane consumers use
        :meth:`open_read_resuming`; bounded-span consumers use
        :meth:`get_range`, which verifies the byte count."""
        if length is not None and length < 0:
            raise ValueError(f"length must be >= 0, got {length}")
        if length == 0:
            # a zero-length span has no valid Range header form; the
            # contract (mirroring get_range) is simply an empty stream
            import io

            return io.BytesIO(b"")
        if length is not None:
            headers = {"Range": f"bytes={offset}-{offset + length - 1}"}
        elif offset:
            headers = {"Range": f"bytes={offset}-"}
        else:
            headers = {}
        return self._retrying(
            lambda: self._request("GET", url, headers=headers))

    def get_range(self, url: str, offset: int, length: int) -> bytes:
        """Exactly the bytes ``[offset, offset+length)`` of an object (or
        up to its end, whichever is shorter), fully read under ``retry``.

        The whole read runs inside the retried closure with the byte
        count VERIFIED against the response headers: a connection dropped
        mid-span — which sized reads otherwise surface as clean EOF, i.e.
        silent truncation — classifies as transient and re-fetches the
        span.  Servers without Range support (HTTP 200) are sliced
        client-side, so callers always get span semantics."""
        if length < 0 or offset < 0:
            raise ValueError(
                f"offset/length must be >= 0, got {offset}/{length}")
        if length == 0:
            return b""
        headers = {"Range": f"bytes={offset}-{offset + length - 1}"}

        def _get() -> bytes:
            with self._request("GET", url, headers=headers) as r:
                data = r.read()
                if r.status == 200:
                    # no Range support: full body came back — verify it
                    # first, then slice the span out
                    cl = r.headers.get("Content-Length")
                    if cl is not None and len(data) < int(cl):
                        raise ObjectStoreError(
                            f"GET {url} truncated: {len(data)}/{cl} bytes",
                            url=url, retryable=True)
                    return data[offset:offset + length]
                expected = length
                crange = r.headers.get("Content-Range", "")
                total_s = crange.rpartition("/")[2]
                if total_s.isdigit():
                    expected = max(0, min(length, int(total_s) - offset))
                elif r.headers.get("Content-Length") is not None:
                    expected = min(length,
                                   int(r.headers["Content-Length"]))
                if len(data) < expected:
                    raise ObjectStoreError(
                        f"ranged GET {url} [{offset}, {offset + length}) "
                        f"truncated: {len(data)}/{expected} bytes",
                        url=url, retryable=True)
                return data[:length]

        return self._retrying(_get)

    def open_read_resuming(self, url: str, *, offset: int = 0,
                           max_resumes: int = 5) -> "ResumingStream":
        """Streaming GET that survives mid-body connection drops (idle
        timeouts on stalled streams, transient resets) by re-issuing a
        ``Range`` read from the exact byte offset — the property the raw
        response cannot give (see :meth:`open_read`)."""
        return ResumingStream(self, url, offset=offset,
                              max_resumes=max_resumes)

    def get(self, url: str) -> bytes:
        # body read inside the retried closure: a connection dropped
        # mid-body re-fetches the whole (bounded-size) object
        def _get() -> bytes:
            with self._request("GET", url) as r:
                return r.read()

        return self._retrying(_get)

    def put(self, url: str, data: bytes) -> None:
        # full-object PUT is idempotent: blind re-PUT converges
        def _put() -> None:
            with self._request("PUT", url, data=data):
                pass

        self._retrying(_put)

    def put_stream(self, url: str, fileobj, length: int) -> None:
        """PUT a seekable/readable body without materializing it: urllib
        streams a file-like ``data`` when Content-Length is explicit.
        Retries rewind seekable bodies; a non-seekable body (pipe) gets
        exactly one attempt — its bytes are gone after a failure.  Seek
        support is duck-probed (SpooledTemporaryFile predates the full
        io ABC: no ``seekable()`` until 3.11)."""
        try:
            start = (fileobj.tell()
                     if callable(getattr(fileobj, "seek", None)) else None)
        except OSError:
            start = None

        def _put() -> None:
            if start is not None:
                fileobj.seek(start)
            with self._request("PUT", url, data=fileobj,
                               headers={"Content-Length": str(length)}):
                pass

        if start is None:
            _put()
        else:
            self._retrying(_put)

    def exists(self, url: str) -> bool:
        try:
            def _head() -> None:
                with self._request("HEAD", url):
                    pass

            self._retrying(_head)
            return True
        except ObjectStoreError as e:
            if e.status == 404:
                return False
            raise

    def size(self, url: str) -> int:
        def _size() -> int:
            with self._request("HEAD", url) as r:
                return int(r.headers["Content-Length"])

        return self._retrying(_size)

    def delete(self, url: str) -> None:
        try:
            def _delete() -> None:
                with self._request("DELETE", url):
                    pass

            self._retrying(_delete)
        except ObjectStoreError as e:
            if e.status != 404:
                raise

    # -- listing -----------------------------------------------------------
    def list_prefix(self, prefix_url: str) -> list[str]:
        """All object URLs under a prefix, via ListObjectsV2 with
        continuation-token pagination (S3 pages at 1000 keys)."""
        endpoint, bucket, key_prefix = _split_bucket(prefix_url)
        keys: list[str] = []
        token: str | None = None
        while True:
            q = {"list-type": "2", "prefix": key_prefix}
            if token:
                q["continuation-token"] = token
            url = f"{endpoint}/{bucket}?{urllib.parse.urlencode(q)}"

            def _page(url=url) -> bytes:
                with self._request("GET", url) as r:
                    return r.read()

            root = ET.fromstring(self._retrying(_page))
            # tolerate both namespaced (real S3) and bare (dev server) XML
            ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
            for c in root.iter(f"{ns}Contents"):
                k = c.find(f"{ns}Key")
                if k is not None and k.text:
                    keys.append(k.text)
            trunc = root.find(f"{ns}IsTruncated")
            token_el = root.find(f"{ns}NextContinuationToken")
            if (trunc is not None and trunc.text == "true"
                    and token_el is not None and token_el.text):
                token = token_el.text
                continue
            return [f"{endpoint}/{bucket}/{k}" for k in keys]

    def delete_prefix(self, prefix_url: str) -> int:
        urls = self.list_prefix(prefix_url)
        for u in urls:
            self.delete(u)
        return len(urls)

    # -- directory mirror (checkpoint sync) --------------------------------
    def upload_tree(self, local_dir: str, prefix_url: str) -> list[str]:
        """PUT every file under ``local_dir`` to ``prefix_url``/<relpath>."""
        uploaded = []
        for root, _, files in os.walk(local_dir):
            for name in files:
                path = os.path.join(root, name)
                rel = os.path.relpath(path, local_dir)
                url = join_url(prefix_url, *rel.split(os.sep))
                with open(path, "rb") as f:
                    self.put(url, f.read())
                uploaded.append(url)
        return uploaded

    def download_tree(self, prefix_url: str, local_dir: str) -> list[str]:
        """GET every object under ``prefix_url`` into ``local_dir``."""
        base = prefix_url.rstrip("/") + "/"
        out = []
        for url in self.list_prefix(base):
            rel = url[len(base):]
            dest = os.path.join(local_dir, *rel.split("/"))
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with self.open_read_resuming(url) as r, open(dest, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            out.append(dest)
        return out


class ResumingStream:
    """File-like streaming GET body with drop-resume.

    Tracks delivered bytes against the first response's Content-Length;
    a premature EOF or mid-read network error triggers a ranged re-GET
    from the exact offset (bounded retries, exponential backoff).  Without
    this, a dropped connection reads as clean EOF under sized reads and an
    epoch silently truncates — worse, a drop landing exactly on a TFRecord
    boundary is undetectable by framing alone.

    The ``max_resumes`` budget bounds CONSECUTIVE no-progress resumes, not
    resumes over the whole body: a resume that delivers new bytes resets
    the budget, so a long stream on a flaky link survives arbitrarily many
    drops as long as each reconnect makes progress, while a dead object
    (every resume stalls at the same offset) still fails fast.
    """

    def __init__(self, store: HttpObjectStore, url: str, *,
                 offset: int = 0, max_resumes: int = 5):
        self._store = store
        self._url = url
        self._offset = offset
        self._max_resumes = max_resumes
        self._resumes = 0
        self.resumes_total = 0
        self._resp = store.open_read(url, offset=offset)
        cl = self._resp.headers.get("Content-Length")
        self._total = offset + int(cl) if cl is not None else None

    def _resume(self) -> None:
        import time

        self._resumes += 1
        if self._resumes > self._max_resumes:
            raise ObjectStoreError(
                f"stream {self._url} dropped at byte {self._offset}"
                + (f"/{self._total}" if self._total is not None else "")
                + f" after {self._max_resumes} resume attempts"
            )
        self.resumes_total += 1
        time.sleep(min(2.0 ** self._resumes * 0.1, 5.0))
        try:
            self._resp.close()
        # da:allow[swallowed-exception] best-effort close of a connection already known dead
        except Exception:
            pass
        self._resp = self._store.open_read(self._url, offset=self._offset)

    def read(self, n: int = -1) -> bytes:
        while True:
            try:
                chunk = self._resp.read(n)
            except (OSError, http.client.HTTPException):
                # partial data buffered inside the failed read is NOT
                # counted in _offset, so the ranged resume re-fetches it
                self._resume()
                continue
            if chunk:
                self._offset += len(chunk)
                # progress: reset the resume budget (it bounds consecutive
                # stalls at one offset, not total drops over the body)
                self._resumes = 0
                return chunk
            if self._total is None or self._offset >= self._total:
                return b""  # genuine end of object
            self._resume()  # premature clean EOF == dropped connection

    def close(self) -> None:
        try:
            self._resp.close()
        # da:allow[swallowed-exception] best-effort close: the stream owner is done with the body either way
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_DEFAULT_STORE: HttpObjectStore | None = None


def get_store() -> HttpObjectStore:
    global _DEFAULT_STORE
    if _DEFAULT_STORE is None:
        _DEFAULT_STORE = HttpObjectStore()
    return _DEFAULT_STORE


def set_store(store: HttpObjectStore | None) -> HttpObjectStore | None:
    """Swap the process-default store (chaos tests install one with a fast
    zero-sleep retry policy).  Returns the previous store; pass it back to
    restore."""
    global _DEFAULT_STORE
    prev, _DEFAULT_STORE = _DEFAULT_STORE, store
    return prev


def open_source(src: str, *, offset: int = 0) -> BinaryIO:
    """Open a local path or object URL for streaming reads (URL streams
    resume dropped connections transparently)."""
    if is_url(src):
        return get_store().open_read_resuming(src, offset=offset)
    f = open(src, "rb")
    if offset:
        f.seek(offset)
    return f


class FifoBridge:
    """Stream the object at ``url`` into the named FIFO ``fifo_dir/name``
    (``path``), for consumers that read paths (the C++ reader).

    Memory is the kernel's pipe buffer.  The writer thread first waits for
    a reader on the FIFO, by a non-blocking open and a poll, so it can be
    called off (``close()``) before anyone reads; only then does it send
    the GET.  A connection dropped mid-body resumes with a ranged re-GET
    from the exact byte offset (``ResumingStream``, at most
    ``_MAX_RESUMES`` stalls in a row), so a drop costs a reconnect, not a
    silently short epoch.  ``finish()`` joins the writer and raises the
    transfer error that the reader's EOF would hide; ``close()`` reaps the
    bridge quietly after the consumer stopped early.  ``bytes`` counts what
    went into the FIFO, ``resumes`` the ranged re-GETs."""

    _MAX_RESUMES = 5
    POLL_SECS = 0.05

    def __init__(self, url: str, fifo_dir: str, name: str):
        self.url = url
        self.path = os.path.join(fifo_dir, name)
        os.mkfifo(self.path)
        self.bytes = 0
        self.resumes = 0
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, name="fifo-bridge",
                                        daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        import errno

        try:
            fd = None
            while fd is None:
                if self._stop.is_set():
                    return
                try:
                    fd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
                except OSError as e:
                    if e.errno != errno.ENXIO:  # ENXIO: no reader yet
                        raise
                    self._stop.wait(self.POLL_SECS)
            os.set_blocking(fd, True)
            with os.fdopen(fd, "wb") as sink, get_store().open_read_resuming(
                    self.url, max_resumes=self._MAX_RESUMES) as r:
                try:
                    while True:
                        chunk = r.read(1 << 20)
                        if not chunk:
                            return
                        sink.write(chunk)
                        self.bytes += len(chunk)
                finally:
                    self.resumes = r.resumes_total
        except BrokenPipeError:
            pass  # the consumer stopped early (a drop_remainder cut, a bound)
        except BaseException as e:  # raised by finish()
            self._err = e

    def finish(self) -> None:
        """Join the writer and raise any transfer error as
        :class:`ObjectStoreError` (a failed GET or a dropped connection
        reads as a clean EOF to the record reader: here it is loud)."""
        self._thread.join()
        if self._err is not None:
            raise ObjectStoreError(
                f"remote stream {self.url} failed: {self._err}") from self._err

    def close(self) -> None:
        """Reap the bridge after the consumer stopped early; never raises."""
        self._stop.set()
        self._thread.join(timeout=10)
