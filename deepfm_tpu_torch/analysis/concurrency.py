"""Engine 3 — interprocedural concurrency analysis (``--concurrency``): the
port's own copy of ``deepfm_tpu/analysis/concurrency.py``, with one change,
the device clause of ``blocking-under-lock`` (below).

The serving/coordination tier is ~30 threaded modules, and review keeps
hand-catching the same bug class: a lock held across I/O or a drain, a
signal handler deadlocking on a non-reentrant lock, two locks taken in
opposite orders on different paths.  The ``guarded-by`` lint (engine 1)
only checks *which* lock guards an attribute; this engine checks what
happens *while the lock is held* — the same move the layout-contract
papers make for SPMD sharding applied to host-side concurrency: the
invariant is checked at analysis time, not discovered in production.

Four rules over the :class:`~.callgraph.CallGraph`:

* ``lock-order-cycle`` — a per-class/per-module lock-acquisition graph:
  edge A→B when B is acquired (directly, or anywhere inside a resolved
  call) while A is held.  A cycle is a potential deadlock; a
  non-reentrant lock re-acquired while already held is a certain one.
* ``blocking-under-lock`` — HTTP/object-store verbs, ``time.sleep``,
  ``subprocess``, blocking ``queue.get/put``, file I/O, thread
  joins/event waits, and a wait on the card reached — transitively,
  through resolved calls — while a lock frame is open.
* ``signal-unsafe-lock`` — a function registered via ``signal.signal``,
  ``register_stop_callback`` (the PreemptionGuard hook), or
  ``sys.excepthook`` must not acquire a non-reentrant lock also taken on
  normal paths: CPython runs handlers on the main thread, so a signal
  landing while that thread holds the lock deadlocks the way down.
* ``thread-lifecycle`` — a started thread whose owning scope has no
  ``.join`` path, a fire-and-forget non-daemon thread, or a daemon
  fire-and-forget thread whose target owns durable state (reaches file
  or object-store writes) — buffered state a process exit silently
  drops.

**The device clause.**  JAX's engine counts every ``jax.*``/``jnp.*`` call
as device dispatch.  A torch call mostly enqueues work and returns, and
many (``torch.from_numpy``, ``torch.tensor`` on the host) never touch the
card, so counting every ``torch.*`` call would convict host code.  The
port counts the calls that make the host wait on the card, or launch a
whole recorded graph:

* ``torch.cuda.synchronize(...)`` and any ``.synchronize()`` (a stream's,
  an event's);
* a graph's ``.replay()``;
* ``.item()`` and ``.cpu()`` with no arguments (a read of a tensor back to
  the host, which waits for the stream).

``.tolist()`` is left out: a numpy array has it too, a parse cannot tell
the two apart, and the host tier calls it on numpy rows under its lock
(tiered/host.py ``HostTier.get_records``).  ``.item()`` of a numpy array
is convicted with the tensor's; move it out of the lock.

**Blessed idioms** (allowlisted so the gate enforces intent, not style):

* *export/dump locks* — a lock whose name says it serializes slow I/O
  (``_export_lock``, ``_dump_lock``, ``_io_lock``, ``_write_lock``,
  ``_flush_lock``, ``_file_lock``) is exempt from blocking-under-lock:
  holding it across the write IS the point, and review has already
  blessed keeping such locks off the request path.  It still
  participates in lock-order analysis.
* *reentrant handlers* — RLock (and default ``Condition``, which wraps
  one) in a signal handler is the sanctioned FlightRecorder idiom, so
  signal-safety convicts non-reentrant locks only.
* *condition waits* — ``self._cv.wait()`` releases ``self._cv``; it
  only counts as blocking-under-lock for OTHER locks still held.

Heldness is interprocedural (mirroring guarded_by.py's lock-held-helper
fixpoint, but per call site): a helper's blocking op is charged to every
call site that reaches it with a lock held, and both ``with self._lock:``
and ``self._lock.acquire()`` / ``try/finally: release()`` regions count.
Findings ride the shared fingerprint/baseline/``da:allow`` machinery.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from .ast_rules import _dotted
from .callgraph import CallGraph, ClassEntry, LockInfo, ModuleEntry
from .findings import Finding

CONCURRENCY_RULES = (
    "lock-order-cycle",
    "blocking-under-lock",
    "signal-unsafe-lock",
    "thread-lifecycle",
)

# lock names whose PURPOSE is serializing slow I/O (tracer export file,
# termination dumps): blocking while holding them is the blessed idiom,
# not the bug — they never guard request-path state
_BLESSED_IO_LOCK_RE = re.compile(
    r"^_?(export|dump|io|write|flush|file)_?lock$")

_OS_BLOCKING = {"replace", "rename", "makedirs", "remove", "unlink",
                "fsync", "rmdir", "listdir", "scandir", "stat"}
_SUBPROCESS_FNS = {"run", "call", "check_call", "check_output", "Popen"}
_REQUESTS_VERBS = {"get", "post", "put", "delete", "head", "patch",
                   "request"}
_STORE_VERBS = {"put", "get", "put_stream", "get_range", "open_read",
                "open_read_resuming", "list_prefix", "delete",
                "delete_prefix", "upload_tree", "download_tree"}

# tensor methods that wait for the card (module docstring: the device clause)
_DEVICE_WAITS = {"replay", "item", "cpu"}

# reporting order when one call site reaches several blocking kinds
_KIND_SEVERITY = ("http", "object-store", "subprocess", "sleep", "queue",
                  "join/wait", "file-io", "device-dispatch")


LockId = tuple  # ("inst", path, Class, attr) | ("glob", path, name)


def _lock_display(lock: LockId) -> str:
    if lock[0] == "inst":
        return f"{lock[2]}.self.{lock[3]}"
    return f"{lock[1].rsplit('/', 1)[-1]}:{lock[2]}"


@dataclass
class _Block:
    kind: str
    desc: str
    line: int
    held: tuple


@dataclass
class _Acquire:
    lock: LockId
    info: LockInfo
    line: int
    held: tuple


@dataclass
class _CallSite:
    target: int              # id() of the resolved function node
    display: str
    line: int
    held: tuple


@dataclass
class _FnFacts:
    path: str
    display: str
    node: ast.AST
    cls: ClassEntry | None
    blocking: list[_Block] = field(default_factory=list)
    acquires: list[_Acquire] = field(default_factory=list)
    calls: list[_CallSite] = field(default_factory=list)


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _FnAnalyzer:
    """One function's lock/blocking/call facts, via an order-aware walk
    that tracks the held-lock frame (``with`` blocks AND acquire/release
    statement pairs)."""

    def __init__(self, graph: CallGraph, entry: ModuleEntry,
                 cls: ClassEntry | None, fn: ast.AST, display: str):
        self.graph = graph
        self.entry = entry
        self.cls = cls
        self.fn = fn
        self.facts = _FnFacts(path=entry.path, display=display, node=fn,
                              cls=cls)

    def run(self) -> _FnFacts:
        body = self.fn.body if not isinstance(self.fn, ast.Lambda) \
            else [ast.Expr(value=self.fn.body)]
        self._stmts(body, [])
        return self.facts

    # -- lock identification ------------------------------------------------

    def _lock_of(self, expr: ast.AST) -> tuple[LockId, LockInfo] | None:
        attr = _self_attr(expr)
        if attr is not None and self.cls is not None:
            info = self.cls.locks.get(attr)
            if info is not None:
                return (("inst", self.cls.path, self.cls.name, attr), info)
        if isinstance(expr, ast.Name):
            info = self.entry.global_locks.get(expr.id)
            if info is not None:
                return (("glob", self.entry.path, expr.id), info)
        return None

    def _acquire(self, lock: LockId, info: LockInfo, line: int,
                 held: list) -> None:
        self.facts.acquires.append(_Acquire(
            lock=lock, info=info, line=line,
            held=tuple(lid for lid, _ in held)))

    # -- statement walk -----------------------------------------------------

    def _stmts(self, stmts: list[ast.stmt], held: list) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # runs later; analyzed as its own function
            if isinstance(st, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for item in st.items:
                    got = self._lock_of(item.context_expr)
                    if got is not None:
                        self._acquire(got[0], got[1], item.context_expr.lineno
                                      if hasattr(item.context_expr, "lineno")
                                      else st.lineno, inner)
                        inner.append(got)
                    else:
                        self._expr(item.context_expr, inner)
                self._stmts(st.body, inner)
                continue
            # the acquire()/release() statement idiom:
            #   self._lock.acquire()
            #   try: ...
            #   finally: self._lock.release()
            paired = self._acquire_release(st)
            if paired is not None:
                lock, info, verb = paired
                if verb == "acquire":
                    self._acquire(lock, info, st.lineno, held)
                    held.append((lock, info))
                else:
                    for i in range(len(held) - 1, -1, -1):
                        if held[i][0] == lock:
                            del held[i]
                            break
                continue
            if isinstance(st, ast.If):
                self._expr(st.test, held)
                self._stmts(st.body, list(held))
                self._stmts(st.orelse, list(held))
                continue
            if isinstance(st, (ast.For, ast.AsyncFor)):
                self._expr(st.iter, held)
                self._stmts(st.body, list(held))
                self._stmts(st.orelse, list(held))
                continue
            if isinstance(st, ast.While):
                self._expr(st.test, held)
                self._stmts(st.body, list(held))
                self._stmts(st.orelse, list(held))
                continue
            if isinstance(st, ast.Try):
                # body and finalbody SHARE the frame: the canonical
                # acquire-before-try / release-in-finally pair balances
                self._stmts(st.body, held)
                for h in st.handlers:
                    self._stmts(h.body, list(held))
                self._stmts(st.orelse, list(held))
                self._stmts(st.finalbody, held)
                continue
            self._expr(st, held)

    def _acquire_release(
        self, st: ast.stmt
    ) -> tuple[LockId, LockInfo, str] | None:
        if not (isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)):
            return None
        call = st.value
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr in ("acquire", "release")):
            return None
        got = self._lock_of(call.func.value)
        if got is None:
            return None
        return got[0], got[1], call.func.attr

    # -- expression walk ----------------------------------------------------

    def _expr(self, node: ast.AST, held: list) -> None:
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(n, ast.Call):
                self._classify_call(n, held)
            stack.extend(ast.iter_child_nodes(n))

    def _classify_call(self, call: ast.Call, held: list) -> None:
        func = call.func
        d = _dotted(func)
        parts = d.split(".") if d else []
        # lock methods in expression position: acquire feeds the order
        # graph (heldness persistence is the statement walk's job)
        if isinstance(func, ast.Attribute) and func.attr in (
                "acquire", "release"):
            got = self._lock_of(func.value)
            if got is not None:
                if func.attr == "acquire":
                    self._acquire(got[0], got[1], call.lineno, held)
                return
        # condition wait: releases ITS OWN lock while waiting
        if isinstance(func, ast.Attribute) and func.attr in (
                "wait", "wait_for"):
            got = self._lock_of(func.value)
            if got is not None and got[1].is_condition:
                other = tuple(lid for lid, _ in held if lid != got[0])
                self.facts.blocking.append(_Block(
                    kind="join/wait",
                    desc=f"{_dotted(func)}() condition wait",
                    line=call.lineno, held=other))
                return
        resolved = self.graph.resolve_call(self.entry.path, self.cls, call)
        if resolved is not None:
            tpath, qual, node = resolved
            self.facts.calls.append(_CallSite(
                target=id(node), display=qual, line=call.lineno,
                held=tuple(lid for lid, _ in held)))
            return
        blocked = self._direct_blocking(call, d, parts)
        if blocked is not None:
            kind, desc = blocked
            self.facts.blocking.append(_Block(
                kind=kind, desc=desc, line=call.lineno,
                held=tuple(lid for lid, _ in held)))

    def _direct_blocking(self, call: ast.Call, d: str,
                         parts: list[str]) -> tuple[str, str] | None:
        func = call.func
        if isinstance(func, ast.Name):
            # from-imported stdlib blockers used as bare names (project
            # functions were already claimed by resolve_call above)
            bare = {"open": ("file-io", "open()"),
                    "urlopen": ("http", "urlopen()"),
                    "sleep": ("sleep", "sleep()")}
            return bare.get(func.id)
        # the device clause (module docstring), on any receiver:
        # torch.cuda.current_stream().synchronize() has no dotted path
        if isinstance(func, ast.Attribute) and (
                func.attr == "synchronize"
                or (func.attr in _DEVICE_WAITS and not call.args and not call.keywords)):
            return ("device-dispatch", f"{d or '.' + func.attr}()")
        if not parts:
            return None
        root, last = parts[0], parts[-1]
        if root == "time" and last == "sleep":
            return ("sleep", "time.sleep()")
        if root == "subprocess" and last in _SUBPROCESS_FNS:
            return ("subprocess", f"{d}()")
        if last == "urlopen" or (root == "socket"
                                 and last == "create_connection"):
            return ("http", f"{d}()")
        if root == "requests" and last in _REQUESTS_VERBS:
            return ("http", f"{d}()")
        if root == "os" and last in _OS_BLOCKING:
            return ("file-io", f"{d}()")
        if root == "shutil":
            return ("file-io", f"{d}()")
        # typed receivers: queues / events / threads on self
        recv_attr = _self_attr(func.value) if isinstance(
            func, ast.Attribute) else None
        if recv_attr is not None and self.cls is not None:
            if recv_attr in self.cls.queue_attrs and last in ("get", "put"):
                for kw in call.keywords:
                    if kw.arg == "block" and isinstance(
                            kw.value, ast.Constant) and kw.value.value is False:
                        return None
                return ("queue", f"blocking {d}()")
            if recv_attr in self.cls.queue_attrs and last == "join":
                return ("join/wait", f"{d}()")
            if recv_attr in self.cls.event_attrs and last == "wait":
                return ("join/wait", f"{d}()")
            if recv_attr in self.cls.thread_attrs and last == "join":
                return ("join/wait", f"{d}()")
        # object-store verbs: get_store().put(...) or a store-named handle
        if isinstance(func, ast.Attribute) and last in _STORE_VERBS:
            recv = func.value
            if isinstance(recv, ast.Call) and _dotted(
                    recv.func).rsplit(".", 1)[-1] == "get_store":
                return ("object-store", f"get_store().{last}()")
            rd = _dotted(recv)
            if rd and "store" in rd.rsplit(".", 1)[-1].lower():
                return ("object-store", f"{d}()")
        return None


class ConcurrencyEngine:
    """Project-wide facts → the four rule passes."""

    def __init__(self, files: dict[str, str], trees: dict[str, ast.Module],
                 graph: CallGraph | None = None):
        self.files = files
        self.graph = graph if graph is not None else CallGraph(files, trees)
        self.facts: dict[int, _FnFacts] = {}
        self._build_facts()
        self._fixpoint()

    # -- facts --------------------------------------------------------------

    def _build_facts(self) -> None:
        for entry in self.graph.modules.values():
            # top-level functions (and everything nested in them)
            for defs in entry.functions.values():
                for fn in defs:
                    self._analyze_tree(entry, None, fn, fn.name)
            for ce in entry.classes.values():
                for mname, defs in ce.methods.items():
                    for fn in defs:
                        self._analyze_tree(entry, ce, fn,
                                           f"{ce.name}.{mname}")

    def _analyze_tree(self, entry: ModuleEntry, cls: ClassEntry | None,
                      fn: ast.AST, display: str) -> None:
        """Facts for ``fn`` and every function nested inside it (nested
        defs inherit the class context — they close over ``self``)."""
        if id(fn) in self.facts:
            return
        self.facts[id(fn)] = _FnAnalyzer(
            self.graph, entry, cls, fn, display).run()
        for sub in ast.iter_child_nodes(fn):
            for node in ast.walk(sub):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)) and node is not fn:
                    name = getattr(node, "name", "<lambda>")
                    self._analyze_tree(entry, cls, node,
                                       f"{display}.{name}")

    # -- transitive summaries ----------------------------------------------

    def _fixpoint(self) -> None:
        # t_block: fn -> {kind: (origin_path, origin_line, desc)}
        # t_acq:   fn -> {lock: (origin_path, origin_line, info)}
        self.t_block: dict[int, dict] = {}
        self.t_acq: dict[int, dict] = {}
        for fid, f in self.facts.items():
            self.t_block[fid] = {
                b.kind: (f.path, b.line, b.desc) for b in f.blocking}
            self.t_acq[fid] = {
                a.lock: (f.path, a.line, a.info) for a in f.acquires}
        changed = True
        while changed:
            changed = False
            for fid, f in self.facts.items():
                for c in f.calls:
                    for kind, origin in self.t_block.get(c.target,
                                                         {}).items():
                        if kind not in self.t_block[fid]:
                            self.t_block[fid][kind] = origin
                            changed = True
                    for lock, origin in self.t_acq.get(c.target, {}).items():
                        if lock not in self.t_acq[fid]:
                            self.t_acq[fid][lock] = origin
                            changed = True

    # -- shared helpers -----------------------------------------------------

    def _src(self, path: str, line: int) -> str:
        lines = self.files.get(path, "").splitlines()
        return lines[line - 1] if 0 < line <= len(lines) else ""

    @staticmethod
    def _filter_blessed(held: tuple) -> tuple:
        return tuple(l for l in held
                     if not _BLESSED_IO_LOCK_RE.match(l[-1]))

    # -- rule: blocking-under-lock ------------------------------------------

    def check_blocking(self) -> list[Finding]:
        out: list[Finding] = []
        seen: set[tuple] = set()
        for fid, f in self.facts.items():
            for b in f.blocking:
                held = self._filter_blessed(b.held)
                if not held:
                    continue
                key = (f.path, b.line, b.kind)
                if key in seen:
                    continue
                seen.add(key)
                locks = ", ".join(sorted(_lock_display(l) for l in held))
                out.append(Finding(
                    rule="blocking-under-lock", path=f.path,
                    line=b.line, col=0,
                    message=(
                        f"{b.desc} ({b.kind}) inside '{f.display}' while "
                        f"holding {locks} — every thread contending on the "
                        f"lock stalls behind this call"
                    ),
                    hint="shrink the lock scope: snapshot state under the "
                         "lock, release, then perform the slow call",
                    source=self._src(f.path, b.line),
                ))
            for c in f.calls:
                held = self._filter_blessed(c.held)
                if not held:
                    continue
                reach = self.t_block.get(c.target)
                if not reach:
                    continue
                kind = next(k for k in _KIND_SEVERITY + tuple(sorted(reach))
                            if k in reach)
                key = (f.path, c.line, "call")
                if key in seen:
                    continue
                seen.add(key)
                opath, oline, odesc = reach[kind]
                locks = ", ".join(sorted(_lock_display(l) for l in held))
                out.append(Finding(
                    rule="blocking-under-lock", path=f.path,
                    line=c.line, col=0,
                    message=(
                        f"call to {c.display}() in '{f.display}' while "
                        f"holding {locks} reaches {odesc} ({kind}, "
                        f"{opath}:{oline}) — the lock is held across the "
                        f"blocking operation"
                    ),
                    hint="move the call outside the held region (snapshot-"
                         "then-release) or make the callee non-blocking",
                    source=self._src(f.path, c.line),
                ))
        return out

    # -- rule: lock-order-cycle ---------------------------------------------

    def check_lock_order(self) -> list[Finding]:
        out: list[Finding] = []
        # edge (A, B) -> witness (path, line, detail)
        edges: dict[tuple, tuple] = {}
        self_deadlocks: dict[tuple, tuple] = {}
        for fid, f in self.facts.items():
            for a in f.acquires:
                for h in a.held:
                    if h == a.lock:
                        if not a.info.reentrant:
                            self_deadlocks.setdefault(
                                (f.path, a.line, a.lock),
                                (f.display, None))
                    else:
                        edges.setdefault((h, a.lock),
                                         (f.path, a.line, f.display, None))
            for c in f.calls:
                for lock, (opath, oline, info) in self.t_acq.get(
                        c.target, {}).items():
                    for h in c.held:
                        if h == lock:
                            if not info.reentrant:
                                self_deadlocks.setdefault(
                                    (f.path, c.line, lock),
                                    (f.display, c.display))
                        else:
                            edges.setdefault(
                                (h, lock),
                                (f.path, c.line, f.display, c.display))
        for (path, line, lock), (display, via) in sorted(
                self_deadlocks.items(), key=lambda kv: (kv[0][0], kv[0][1])):
            via_s = f" (via {via}())" if via else ""
            out.append(Finding(
                rule="lock-order-cycle", path=path, line=line, col=0,
                message=(
                    f"non-reentrant {_lock_display(lock)} re-acquired in "
                    f"'{display}'{via_s} while already held — guaranteed "
                    f"self-deadlock"
                ),
                hint="drop the inner acquire (the caller already holds "
                     "it) or make the lock an RLock with a comment saying "
                     "why re-entry is safe",
                source=self._src(path, line),
            ))
        # cycles among distinct locks: SCCs of the order graph
        graph: dict[LockId, set[LockId]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        for scc in _sccs(graph):
            if len(scc) < 2:
                continue
            cyc = sorted(_lock_display(l) for l in scc)
            for (a, b), (path, line, display, via) in sorted(
                    edges.items(), key=lambda kv: (kv[1][0], kv[1][1])):
                if a in scc and b in scc:
                    via_s = f" via {via}()" if via else ""
                    out.append(Finding(
                        rule="lock-order-cycle", path=path, line=line,
                        col=0,
                        message=(
                            f"lock-order cycle among {{{', '.join(cyc)}}}: "
                            f"'{display}' acquires {_lock_display(b)}"
                            f"{via_s} while holding {_lock_display(a)} — "
                            f"another path takes them in the opposite "
                            f"order (potential deadlock)"
                        ),
                        hint="impose one global acquisition order (or "
                             "release the outer lock before taking the "
                             "inner one)",
                        source=self._src(path, line),
                    ))
        return out

    # -- rule: signal-unsafe-lock -------------------------------------------

    def _enclosing_fn(self, entry: ModuleEntry,
                      node: ast.AST) -> _FnFacts | None:
        """Innermost analyzed function whose body contains ``node``."""
        best = None
        for f in self.facts.values():
            if f.path != entry.path:
                continue
            if any(n is node for n in ast.walk(f.node)):
                if best is None or getattr(f.node, "lineno", 0) > getattr(
                        best.node, "lineno", 0):
                    best = f
        return best

    def _resolve_handler(self, entry: ModuleEntry,
                         scope: _FnFacts | None,
                         expr: ast.AST) -> tuple[int, str] | None:
        """Handler expression -> (facts id, display name).  ``scope`` is
        the registering function's facts (None for module level)."""
        if isinstance(expr, ast.Lambda):
            if id(expr) not in self.facts:
                # module-level lambdas are not reachable from any def
                self._analyze_tree(entry, scope.cls if scope else None,
                                   expr, "<lambda>")
            return (id(expr), "<lambda>")
        if isinstance(expr, ast.Name):
            # nearest nested def in the registering function wins
            search = scope.node if scope is not None else entry.tree
            for node in ast.walk(search):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node.name == expr.id and id(node) in self.facts:
                    return (id(node), expr.id)
            for fn in entry.functions.get(expr.id, ()):
                if id(fn) in self.facts:
                    return (id(fn), expr.id)
            imp = entry.imports.get(expr.id)
            if imp and imp[0] == "sym":
                target = self.graph.modules.get(imp[1])
                if target:
                    for fn in target.functions.get(imp[2], ()):
                        if id(fn) in self.facts:
                            return (id(fn), expr.id)
            return None
        # bound method: signal.signal(sig, self._on_term)
        attr = _self_attr(expr)
        if attr is not None and scope is not None and scope.cls is not None:
            for fn in scope.cls.methods.get(attr, ()):
                if id(fn) in self.facts:
                    return (id(fn), f"{scope.cls.name}.{attr}")
        return None

    def check_signal_safety(self) -> list[Finding]:
        out: list[Finding] = []
        # registrations anywhere in a module — function bodies AND module
        # top level (where signal.signal usually lives)
        handlers: list[tuple[str, str, int, int, str]] = []
        for entry in self.graph.modules.values():
            for node in ast.walk(entry.tree):
                api = expr = None
                if isinstance(node, ast.Call):
                    d = _dotted(node.func)
                    parts = d.split(".") if d else []
                    if (parts and parts[-1] == "signal" and len(parts) > 1
                            and len(node.args) >= 2):
                        api, expr = "signal.signal", node.args[1]
                    elif (parts and parts[-1] == "register_stop_callback"
                          and node.args):
                        api, expr = "register_stop_callback", node.args[0]
                elif isinstance(node, ast.Assign) and any(
                        _dotted(t) == "sys.excepthook"
                        for t in node.targets):
                    api, expr = "sys.excepthook", node.value
                if api is None:
                    continue
                scope = self._enclosing_fn(entry, node)
                got = self._resolve_handler(entry, scope, expr)
                if got is not None:
                    handlers.append((entry.path, api, node.lineno,
                                     got[0], got[1]))
        # who acquires each lock, project-wide (for "also taken on normal
        # paths")
        acquirers: dict[LockId, set[int]] = {}
        for fid, f in self.facts.items():
            for a in f.acquires:
                acquirers.setdefault(a.lock, set()).add(fid)
        seen: set[tuple] = set()
        for rpath, api, line, hid, hname in handlers:
            closure = self._closure(hid)
            for cid in closure:
                cf = self.facts.get(cid)
                if cf is None:
                    continue
                for a in cf.acquires:
                    if a.info.reentrant:
                        continue
                    outside = acquirers.get(a.lock, set()) - set(closure)
                    if not outside:
                        continue
                    key = (rpath, line, a.lock)
                    if key in seen:
                        continue
                    seen.add(key)
                    other = min((self.facts[i] for i in outside
                                 if i in self.facts),
                                key=lambda of: (of.path, of.display))
                    out.append(Finding(
                        rule="signal-unsafe-lock", path=rpath,
                        line=line, col=0,
                        message=(
                            f"handler '{hname}' registered via {api} "
                            f"acquires non-reentrant "
                            f"{_lock_display(a.lock)} "
                            f"({cf.path}:{a.line}) also taken on normal "
                            f"paths (e.g. '{other.display}') — a signal "
                            f"landing while the main thread holds it "
                            f"deadlocks the handler"
                        ),
                        hint="make the lock an RLock (document why "
                             "re-entry is safe) or keep the handler "
                             "lock-free (set an Event, defer the work)",
                        source=self._src(rpath, line),
                    ))
        return out

    def _closure(self, root: int) -> dict[int, None]:
        """Transitive callee set in deterministic BFS order (an id()-based
        sort would pick a run-dependent witness for the report)."""
        seen: dict[int, None] = {root: None}
        frontier = [root]
        while frontier:
            fid = frontier.pop(0)
            f = self.facts.get(fid)
            if f is None:
                continue
            for c in f.calls:
                if c.target not in seen:
                    seen[c.target] = None
                    frontier.append(c.target)
        return seen

    # -- rule: thread-lifecycle ---------------------------------------------

    def check_thread_lifecycle(self) -> list[Finding]:
        out: list[Finding] = []
        for entry in self.graph.modules.values():
            for ce in entry.classes.values():
                out.extend(self._class_threads(entry, ce))
            # fire-and-forget starts anywhere in the module
            for node in ast.walk(entry.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "start"
                        and isinstance(node.func.value, ast.Call)):
                    continue
                ctor = node.func.value
                if _dotted(ctor.func).rsplit(".", 1)[-1] != "Thread":
                    continue
                daemon = any(
                    kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in ctor.keywords)
                if not daemon:
                    out.append(Finding(
                        rule="thread-lifecycle", path=entry.path,
                        line=node.lineno, col=0,
                        message=(
                            "fire-and-forget non-daemon thread: no handle "
                            "to join or stop it, and interpreter exit "
                            "blocks on it forever"
                        ),
                        hint="keep the Thread object and give its owner a "
                             "join/stop path, or mark it daemon=True if "
                             "abandonment at exit is genuinely safe",
                        source=self._src(entry.path, node.lineno),
                    ))
                    continue
                durable = self._target_durability(entry, ctor)
                if durable is not None:
                    out.append(Finding(
                        rule="thread-lifecycle", path=entry.path,
                        line=node.lineno, col=0,
                        message=(
                            f"daemon fire-and-forget thread owns durable "
                            f"state (target reaches {durable[2]} at "
                            f"{durable[0]}:{durable[1]}) — buffered "
                            f"writes are silently lost at process exit"
                        ),
                        hint="keep the Thread object and drain/join it on "
                             "shutdown; daemon threads are killed "
                             "mid-write",
                        source=self._src(entry.path, node.lineno),
                    ))
        return out

    def _class_threads(self, entry: ModuleEntry,
                       ce: ClassEntry) -> list[Finding]:
        out: list[Finding] = []
        starts: list[tuple[str, int]] = []       # (attr, line)
        joined = False
        for defs in ce.methods.values():
            for fn in defs:
                for node in ast.walk(fn):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)):
                        if node.func.attr == "join":
                            joined = True
                        if node.func.attr == "start":
                            attr = _self_attr(node.func.value)
                            if attr in ce.thread_attrs:
                                starts.append((attr, node.lineno))
        if joined:
            return out
        for attr, line in starts:
            out.append(Finding(
                rule="thread-lifecycle", path=entry.path, line=line, col=0,
                message=(
                    f"'{ce.name}.self.{attr}' is started but no method of "
                    f"the class ever joins a thread — there is no stop "
                    f"path, so shutdown either leaks the thread or "
                    f"abandons its in-flight state"
                ),
                hint="add a close()/stop() that signals the loop and "
                     "joins the thread (with a timeout)",
                source=self._src(entry.path, line),
            ))
        return out

    def _target_durability(self, entry: ModuleEntry,
                           ctor: ast.Call) -> tuple | None:
        """(path, line, desc) of durable-state I/O reached by the thread
        target, when the target resolves to a project function."""
        target = next((kw.value for kw in ctor.keywords
                       if kw.arg == "target"), None)
        if target is None:
            return None
        fid = None
        if isinstance(target, ast.Name):
            for fn in entry.functions.get(target.id, ()):
                fid = id(fn)
                break
        elif _self_attr(target) is not None:
            for ce in entry.classes.values():
                for fn in ce.methods.get(_self_attr(target), ()):
                    if any(n is ctor for n in ast.walk(ce.node)):
                        fid = id(fn)
                        break
        if fid is None:
            return None
        reach = self.t_block.get(fid, {})
        for kind in ("object-store", "file-io"):
            if kind in reach:
                return reach[kind]
        return None


def _sccs(graph: dict) -> list[set]:
    """Tarjan strongly-connected components (iterative)."""
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    out: list[set] = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()), key=repr)))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append(
                        (nxt, iter(sorted(graph.get(nxt, ()), key=repr))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                out.append(comp)
    return out


def run_concurrency_engine(
    files: dict[str, str], trees: dict[str, ast.Module],
    graph: CallGraph | None = None,
) -> list[Finding]:
    """Engine 3 over {relpath: source}: the four concurrency rules.
    Suppressions/fingerprints are the caller's job (cli.run_ast_engine
    pools engines so one ``da:allow`` pass covers all of them; it shares
    its ``graph`` with engine 1)."""
    eng = ConcurrencyEngine(files, trees, graph)
    findings = (eng.check_blocking() + eng.check_lock_order()
                + eng.check_signal_safety() + eng.check_thread_lifecycle())
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
