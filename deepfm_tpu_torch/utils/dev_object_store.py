"""Directory-backed test double of an object store, speaking the S3 wire
subset: the port's copy of ``deepfm_tpu/utils/dev_object_store.py``.  It
serves an on-disk root over HTTP with the verbs
``deepfm_tpu_torch.data.object_store.HttpObjectStore`` uses:

    GET    /bucket/key            object bytes (``Range: bytes=N-M``)
    GET    /bucket?list-type=2    ListObjectsV2 XML (+ continuation token)
    PUT    /bucket/key            write object (parents auto-created)
    HEAD   /bucket/key            size probe
    DELETE /bucket/key            remove object

Buckets are first-level directories under the root; keys map to file
paths (guarded against traversal).  Listings page at ``--max-keys``
(default 1000; set it low to exercise the continuation path).

Fault injection: every request first consults a :class:`FaultPlan`, an
ordered rule list matched on verb (``GET/PUT/HEAD/DELETE/LIST/*``) and key
glob, each rule firing a bounded number of times with an optional seeded
probability.  A fired rule returns an error status, adds latency,
truncates a GET body mid-stream (full Content-Length advertised, the
connection closed early) or drops the connection.  Script it in-process
(``server.fault_plan.add(verb="PUT", key="*/MANIFEST-*", times=2,
status=500)``) or over HTTP (``POST /__faults__ {"seed": 7, "rules":
[...]}``, ``GET`` for the plan and its counters, ``DELETE`` to clear).

Run standalone:  python -m deepfm_tpu_torch.utils.dev_object_store --root DIR
In tests:        serve(root, max_keys=...) -> (server, base_url)
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import random
import threading
import time
import urllib.parse
from dataclasses import asdict, dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape

_FAULT_PATH = "/__faults__"


@dataclass
class FaultRule:
    """One scripted failure: fires on requests whose verb and ``/bucket/key``
    path match, at most ``times`` times (-1 = unlimited), with probability
    ``probability`` per matching request (seeded — reproducible)."""

    verb: str = "*"            # GET | PUT | HEAD | DELETE | LIST | *
    key: str = "*"             # glob over "bucket/key" (LIST: "bucket/prefix")
    times: int = -1            # firings remaining; -1 = unlimited
    status: int = 0            # >0: respond with this HTTP error code
    delay_secs: float = 0.0    # added latency before the verb proceeds
    truncate: float = 0.0      # (0,1): fraction of a GET body served, then cut
    drop: bool = False         # close the connection with no response at all
    probability: float = 1.0
    fired: int = field(default=0)  # observability: how often this rule hit

    def matches(self, verb: str, key: str) -> bool:
        return ((self.verb == "*" or self.verb == verb)
                and fnmatch.fnmatchcase(key, self.key))


class FaultPlan:
    """Thread-safe ordered rule set; first matching armed rule fires."""

    def __init__(self, *, seed: int = 0):
        self._lock = threading.Lock()
        self._rules: list[FaultRule] = []
        self._rng = random.Random(seed)
        self._seed = seed
        self.fired_total = 0

    def add(self, **kw) -> FaultRule:
        rule = FaultRule(**kw)
        with self._lock:
            self._rules.append(rule)
        return rule

    def set_rules(self, rules, *, seed: int | None = None) -> None:
        """Replace the plan (each item a FaultRule or a kwargs dict)."""
        parsed = [r if isinstance(r, FaultRule) else FaultRule(**r)
                  for r in rules]
        with self._lock:
            self._rules = parsed
            if seed is not None:
                self._rng = random.Random(seed)
                self._seed = seed

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    def match(self, verb: str, key: str) -> FaultRule | None:
        """First armed matching rule, with its firing recorded — calling
        this IS the fault decision, so each request consumes at most one
        firing of one rule."""
        with self._lock:
            for rule in self._rules:
                if rule.times == 0 or not rule.matches(verb, key):
                    continue
                if rule.probability < 1.0 and (
                        self._rng.random() >= rule.probability):
                    continue
                if rule.times > 0:
                    rule.times -= 1
                rule.fired += 1
                self.fired_total += 1
                return rule
        return None

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "seed": self._seed,
                "fired_total": self.fired_total,
                "rules": [asdict(r) for r in self._rules],
            }


def _make_handler(root: str, max_keys: int, plan: FaultPlan):
    root = os.path.abspath(root)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True  # keep-alive without 40ms Nagle stalls

        def log_message(self, *a):  # quiet
            pass

        # -- helpers -------------------------------------------------------
        def _path_for(self, raw: str) -> str | None:
            """Decoded fs path for /bucket/key, or None on traversal."""
            rel = urllib.parse.unquote(raw).lstrip("/")
            path = os.path.abspath(os.path.join(root, rel))
            if path != root and not path.startswith(root + os.sep):
                return None
            return path

        def _send(self, code: int, body: bytes = b"",
                  ctype: str = "application/octet-stream") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def _drop_connection(self) -> None:
            """Vanish mid-exchange: no response bytes, TCP reset-ish close —
            what a crashed or idle-timing-out store looks like on the wire."""
            self.close_connection = True
            try:
                self.connection.close()
            except OSError:
                pass

        def _inject(self, verb: str) -> tuple[FaultRule | None, bool]:
            """Consult the fault plan.  Returns ``(rule, handled)``:
            ``handled`` means the response (error/drop) was already sent;
            a ``(rule, False)`` leaves verb-specific effects (truncate) to
            the caller; ``(None, False)`` means proceed normally."""
            key = urllib.parse.unquote(
                urllib.parse.urlsplit(self.path).path).lstrip("/")
            rule = plan.match(verb, key)
            if rule is None:
                return None, False
            if rule.delay_secs > 0:
                time.sleep(rule.delay_secs)
            if rule.drop:
                self._drop_connection()
                return rule, True
            if rule.status:
                self._send(rule.status, b"injected fault", "text/plain")
                return rule, True
            return rule, False

        def _fault_handled(self, verb: str) -> bool:
            _, handled = self._inject(verb)
            return handled

        # -- verbs ---------------------------------------------------------
        def do_GET(self) -> None:
            parsed = urllib.parse.urlsplit(self.path)
            if parsed.path == _FAULT_PATH:
                return self._send(200, json.dumps(plan.to_dict()).encode(),
                                  "application/json")
            q = urllib.parse.parse_qs(parsed.query)
            if q.get("list-type") == ["2"]:
                bucket = parsed.path.strip("/")
                prefix = q.get("prefix", [""])[0]
                rule = plan.match("LIST", f"{bucket}/{prefix}")
                if rule is not None:
                    if rule.delay_secs > 0:
                        time.sleep(rule.delay_secs)
                    if rule.drop:
                        return self._drop_connection()
                    if rule.status:
                        return self._send(rule.status, b"injected fault",
                                          "text/plain")
                return self._do_list(parsed, q)
            rule, handled = self._inject("GET")
            if handled:
                return
            path = self._path_for(parsed.path)
            if path is None or not os.path.isfile(path):
                return self._send(404, b"no such key", "text/plain")
            size = os.path.getsize(path)
            cut = None
            if rule is not None and 0.0 < rule.truncate < 1.0:
                cut = rule.truncate
            rng = self.headers.get("Range")
            if rng and rng.startswith("bytes="):
                # partial read: SEEK to the span, never load the whole
                # object — cold-tier row pages ride this path against
                # multi-GB segments.  Fault rules (status/delay/drop
                # handled above, truncate below) apply to ranged reads
                # exactly as to full GETs.
                spec = rng[len("bytes="):]
                start_s, _, end_s = spec.partition("-")
                if not start_s:  # suffix form "bytes=-N": last N bytes
                    start = max(0, size - int(end_s or 0))
                    end = size - 1
                else:
                    start = int(start_s)
                    end = min(int(end_s), size - 1) if end_s else size - 1
                if start >= size or end < start:
                    self.send_response(416)
                    self.send_header("Content-Range", f"bytes */{size}")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                part_len = end - start + 1
                with open(path, "rb") as f:
                    f.seek(start)
                    part = f.read(part_len)
                self.send_response(206)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header(
                    "Content-Range", f"bytes {start}-{end}/{size}")
                self.send_header("Content-Length", str(len(part)))
                self.end_headers()
                if cut is not None:
                    # mid-body truncation: advertised length, early close
                    self.wfile.write(part[: max(0, int(len(part) * cut))])
                    self._drop_connection()
                    return
                self.wfile.write(part)
                return
            with open(path, "rb") as f:
                data = f.read()
            if cut is not None:
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data[: max(0, int(len(data) * cut))])
                self._drop_connection()
                return
            self._send(200, data)

        def _do_list(self, parsed, q) -> None:
            bucket = parsed.path.strip("/")
            bucket_dir = self._path_for("/" + bucket)
            if bucket_dir is None:
                return self._send(403, b"traversal", "text/plain")
            # buckets are created implicitly by the first PUT, so a
            # never-written bucket lists as empty (the bootstrap state a
            # fresh region store starts in), not as an error
            if not os.path.isdir(bucket_dir):
                bucket_dir = None
            prefix = q.get("prefix", [""])[0]
            token = q.get("continuation-token", [""])[0]
            keys = []
            for r, _, files in (os.walk(bucket_dir) if bucket_dir else ()):
                for name in files:
                    rel = os.path.relpath(os.path.join(r, name), bucket_dir)
                    key = rel.replace(os.sep, "/")
                    if key.startswith(prefix):
                        keys.append(key)
            keys.sort()
            if token:  # token = last key of the previous page
                keys = [k for k in keys if k > token]
            page, truncated = keys[:max_keys], len(keys) > max_keys
            parts = [
                "<?xml version='1.0' encoding='UTF-8'?>",
                "<ListBucketResult>",
                f"<Name>{escape(bucket)}</Name>",
                f"<Prefix>{escape(prefix)}</Prefix>",
                f"<KeyCount>{len(page)}</KeyCount>",
                f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>",
            ]
            if truncated and page:
                parts.append(
                    f"<NextContinuationToken>{escape(page[-1])}"
                    "</NextContinuationToken>")
            for k in page:
                parts.append(f"<Contents><Key>{escape(k)}</Key></Contents>")
            parts.append("</ListBucketResult>")
            self._send(200, "".join(parts).encode(), "application/xml")

        def do_HEAD(self) -> None:
            if self._fault_handled("HEAD"):
                return
            path = self._path_for(urllib.parse.urlsplit(self.path).path)
            if path is None or not os.path.isfile(path):
                return self._send(404)
            self.send_response(200)
            self.send_header("Content-Length", str(os.path.getsize(path)))
            self.end_headers()

        def do_POST(self) -> None:
            if urllib.parse.urlsplit(self.path).path != _FAULT_PATH:
                return self._send(404, b"no such endpoint", "text/plain")
            try:
                length = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(length) or b"{}")
                plan.set_rules(doc.get("rules", []), seed=doc.get("seed"))
            except (ValueError, TypeError) as e:
                return self._send(
                    400, f"bad fault plan: {e}".encode(), "text/plain")
            self._send(200, json.dumps(
                {"ok": True, "rules": len(doc.get("rules", []))}).encode(),
                "application/json")

        def do_PUT(self) -> None:
            # the request body must be drained even when a fault preempts
            # the verb, or the keep-alive connection desynchronizes
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            if self._fault_handled("PUT"):
                return
            path = self._path_for(urllib.parse.urlsplit(self.path).path)
            if path is None:
                return self._send(403, b"traversal", "text/plain")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp_put"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic publish, S3-like
            self._send(200)

        def do_DELETE(self) -> None:
            if urllib.parse.urlsplit(self.path).path == _FAULT_PATH:
                plan.clear()
                return self._send(200, b'{"ok": true}', "application/json")
            if self._fault_handled("DELETE"):
                return
            path = self._path_for(urllib.parse.urlsplit(self.path).path)
            if path is None or not os.path.isfile(path):
                return self._send(404)
            os.remove(path)
            self._send(204)

    return Handler


def serve(root: str, *, host: str = "127.0.0.1", port: int = 0,
          max_keys: int = 1000,
          fault_plan: FaultPlan | None = None,
          ) -> tuple[ThreadingHTTPServer, str]:
    """Start a daemon-thread server; returns (server, base_url).  Callers
    own shutdown: ``server.shutdown(); server.server_close()``.  The
    (possibly supplied) fault plan rides on ``server.fault_plan`` for
    in-process chaos scripting."""
    plan = fault_plan if fault_plan is not None else FaultPlan()
    server = ThreadingHTTPServer(
        (host, port), _make_handler(root, max_keys, plan))
    server.daemon_threads = True
    server.fault_plan = plan  # type: ignore[attr-defined]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://{host}:{server.server_address[1]}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--max-keys", type=int, default=1000)
    args = ap.parse_args()
    server, url = serve(args.root, host=args.host, port=args.port,
                        max_keys=args.max_keys)
    print(f"dev object store on {url} serving {os.path.abspath(args.root)}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
