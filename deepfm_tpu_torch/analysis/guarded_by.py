"""Guarded-by race lint (engine 1, rule ``guarded-by``): the port's own
copy of ``deepfm_tpu/analysis/guarded_by.py``.

For each class owning a lock attribute (``self._lock = threading.Lock()``
/ ``RLock`` / ``Condition`` in ``__init__``), infer the *guarded set*: the
instance attributes accessed inside a ``with self._lock:`` block anywhere
in the class.  Then flag every **mutation** (assign, aug-assign — the
compound read-modify-write case — subscript store, or a mutating container
method like ``.append``/``.pop``) of a guarded attribute that happens
outside any lock-held region.

Two deliberate allowances keep the lint honest instead of noisy:

* ``__init__`` is exempt — the object is not yet published to other
  threads while it constructs itself;
* a *lock-held helper* — a method every intra-class call site of which is
  itself inside a held region (``record_failure`` → ``self._trip()``) —
  counts as held, computed to a fixpoint.  Lexical ``with`` blocks alone
  would flag exactly the factored-out-critical-section style the threaded
  modules use.

Plain unguarded *reads* are not flagged: for the monotonic counters and
snapshot patterns in this codebase they are benign (torn reads of a word
are not possible in CPython) and flagging them would bury the real races —
the unguarded *writes* racing the guarded readers.
"""

from __future__ import annotations

import ast

from .ast_rules import _dotted
from .findings import Finding

_LOCK_TYPES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_MUTATING_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "remove", "discard", "add", "clear", "update",
    "setdefault", "sort", "reverse", "rotate",
}


def _self_attr(node: ast.AST) -> str | None:
    """'x' for a bare ``self.x``; None for deeper paths (self.a.b is an
    access of 'a', handled by the caller passing node.value)."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> set[str]:
    locks = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            d = _dotted(node.value.func)
            if d.rsplit(".", 1)[-1] in _LOCK_TYPES:
                for t in node.targets:
                    name = _self_attr(t)
                    if name:
                        locks.add(name)
    return locks


class _Access:
    __slots__ = ("attr", "line", "col", "kind", "held", "method", "source_ok")

    def __init__(self, attr, line, col, kind, held, method):
        self.attr = attr
        self.line = line
        self.col = col
        self.kind = kind          # "read" | "write"
        self.held = held          # lexically inside `with self.<lock>`
        self.method = method


def _collect_accesses(
    method: ast.AST, locks: set[str]
) -> tuple[list[_Access], list[tuple[str, bool]]]:
    """-> (attribute accesses, intra-class self-method calls with heldness)."""
    accesses: list[_Access] = []
    calls: list[tuple[str, bool]] = []
    mname = method.name

    def _ar_verb(st: ast.stmt) -> str | None:
        """'acquire'/'release' for a bare ``self.<lock>.acquire()`` /
        ``.release()`` expression statement, else None."""
        if (isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)
                and isinstance(st.value.func, ast.Attribute)
                and st.value.func.attr in ("acquire", "release")
                and (_self_attr(st.value.func.value) or "") in locks):
            return st.value.func.attr
        return None

    def visit_body(stmts: list[ast.stmt], held: bool) -> None:
        """Statement sequence in order: ``self._lock.acquire()`` opens a
        held region that a later ``release()`` — including one in the
        ``finally`` of the canonical acquire/try/finally pair — closes."""
        ar = 0  # acquire() depth opened within THIS sequence
        for st in stmts:
            verb = _ar_verb(st)
            if verb == "acquire":
                ar += 1
                continue
            if verb == "release":
                ar = max(0, ar - 1)
                continue
            h = held or ar > 0
            if isinstance(st, ast.Try) and ar > 0:
                visit_body(st.body, h)
                for hd in st.handlers:
                    visit_body(hd.body, h)
                visit_body(st.orelse, h)
                visit_body(st.finalbody, h)
                # `finally: self._lock.release()` ends the region for
                # whatever follows the try statement
                if any(_ar_verb(x) == "release" for x in st.finalbody):
                    ar -= 1
                continue
            visit(st, h)

    def visit(node: ast.AST, held: bool) -> None:
        if isinstance(node, ast.With):
            item_locks = any(
                (_self_attr(it.context_expr) or "") in locks
                for it in node.items
            )
            for it in node.items:
                visit(it.context_expr, held)
            visit_body(node.body, held or item_locks)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not method:
            return  # nested defs run later / elsewhere; heldness unknown
        if isinstance(node, ast.Try):
            visit_body(node.body, held)
            for h in node.handlers:
                visit_body(h.body, held)
            visit_body(node.orelse, held)
            visit_body(node.finalbody, held)
            return
        if isinstance(node, ast.If):
            visit(node.test, held)
            visit_body(node.body, held)
            visit_body(node.orelse, held)
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    continue
                visit(child, held)
            visit_body(node.body, held)
            visit_body(node.orelse, held)
            return
        if isinstance(node, ast.Delete):
            # del self.attr / del self.attr[k]: a mutation like any other
            for t in node.targets:
                base = (_self_attr(t)
                        or (isinstance(t, ast.Subscript)
                            and _self_attr(t.value)) or None)
                if base:
                    accesses.append(_Access(
                        base, t.lineno, t.col_offset, "write", held, mname
                    ))
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if isinstance(node, ast.Assign):
                targets = node.targets
            else:  # AugAssign / AnnAssign (self.x: T = v)
                targets = [node.target]
            # flatten tuple/list/starred unpacking: `self.a, self.b = ...`
            # mutates both attributes
            flat: list[ast.AST] = []
            stack = list(targets)
            while stack:
                t = stack.pop()
                if isinstance(t, (ast.Tuple, ast.List)):
                    stack.extend(t.elts)
                elif isinstance(t, ast.Starred):
                    stack.append(t.value)
                else:
                    flat.append(t)
            for t in flat:
                name = _self_attr(t)
                if name:
                    accesses.append(_Access(
                        name, t.lineno, t.col_offset, "write", held, mname
                    ))
                elif isinstance(t, ast.Subscript):
                    base = _self_attr(t.value)
                    if base:
                        accesses.append(_Access(
                            base, t.lineno, t.col_offset, "write", held, mname
                        ))
            if node.value is not None:  # bare annotation: self.x: int
                visit(node.value, held)
            return
        if isinstance(node, ast.Call):
            # self.attr.append(...) style container mutation
            if isinstance(node.func, ast.Attribute):
                base = _self_attr(node.func.value)
                if base and node.func.attr in _MUTATING_METHODS:
                    accesses.append(_Access(
                        base, node.lineno, node.col_offset, "write", held,
                        mname,
                    ))
                # self.helper(...) intra-class call
                m = _self_attr(node.func)
                if m:
                    calls.append((m, held))
        if isinstance(node, ast.Attribute):
            name = _self_attr(node)
            if name:
                accesses.append(_Access(
                    name, node.lineno, node.col_offset, "read", held, mname
                ))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    visit_body(method.body, False)
    return accesses, calls


def check_guarded_by(path: str, src: str, tree: ast.Module) -> list[Finding]:
    out: list[Finding] = []
    src_lines = src.splitlines()
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        locks = _lock_attrs(cls)
        if not locks:
            continue
        methods = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        per_method: dict[str, tuple[list[_Access], list[tuple[str, bool]]]] = {
            m.name: _collect_accesses(m, locks) for m in methods
        }
        # fixpoint: a method is held-by-callers when every intra-class call
        # site is held (lexically or via an already-held caller)
        held_methods: set[str] = set()
        changed = True
        while changed:
            changed = False
            callsites: dict[str, list[bool]] = {}
            for mname, (_acc, calls) in per_method.items():
                for callee, held in calls:
                    callsites.setdefault(callee, []).append(
                        held or mname in held_methods
                    )
            for callee, helds in callsites.items():
                if (callee in per_method and callee not in held_methods
                        and helds and all(helds)):
                    held_methods.add(callee)
                    changed = True
        # guarded set: attrs accessed under a held region (lexical or via
        # held helper), excluding the locks themselves
        guarded: set[str] = set()
        for mname, (accesses, _calls) in per_method.items():
            for a in accesses:
                if (a.held or mname in held_methods) and a.attr not in locks:
                    guarded.add(a.attr)
        if not guarded:
            continue
        for mname, (accesses, _calls) in per_method.items():
            if mname == "__init__":
                continue
            for a in accesses:
                if (a.kind == "write" and a.attr in guarded
                        and not a.held and mname not in held_methods):
                    out.append(Finding(
                        rule="guarded-by", path=path,
                        line=a.line, col=a.col,
                        message=(
                            f"'{cls.name}.{a.attr}' is accessed under "
                            f"{'/'.join(sorted('self.' + x for x in locks))} "
                            f"elsewhere but mutated lock-free in "
                            f"'{mname}' — races the guarded readers/writers"
                        ),
                        hint=f"move the mutation inside `with "
                             f"self.{sorted(locks)[0]}:` (or prove "
                             f"single-thread ownership and suppress with a "
                             f"justification)",
                        source=(src_lines[a.line - 1]
                                if 0 < a.line <= len(src_lines) else ""),
                    ))
    return out
