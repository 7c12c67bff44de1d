"""Project-wide call graph — the substrate for engine 3 (concurrency.py)
and for engine 1's capture reachability (ast_rules.py): the port's own
copy of ``deepfm_tpu/analysis/callgraph.py``.

Engine 1's rules are local to a function or a class; the concurrency
rules are not: a lock-order cycle spans methods, a blocking call hides
two frames below the ``with self._lock:`` that makes it a bug, and a
signal handler's reachability closure crosses modules.  This module
builds the resolution layer those rules interrogate:

* **module index** — every analyzed file keyed by repo-relative path AND
  by dotted module name, so relative imports (``from ...online.publisher
  import latest_manifest`` inside ``deepfm_tpu_torch/serve/pool/swap.py``)
  resolve to the defining file;
* **class index** — methods, base classes, and *typed attributes*:
  ``self._writer = SegmentWriter(...)`` in ``__init__`` records that
  ``self._writer.append(...)`` calls ``SegmentWriter.append``; the same
  inference types lock / queue / event / thread / condition attributes
  (and module globals: ``_RECORDER = FlightRecorder()``);
* **call resolution** — best-effort static resolution of a ``Call`` node
  to the ``(path, qualname)`` of the function it invokes: bare names
  (module functions, imported symbols), ``self.method`` (including
  inherited methods when the base class is in the project),
  ``self.attr.method`` / ``GLOBAL.method`` via typed attributes, and
  ``alias.func`` via module imports.  Unresolvable calls return None —
  the engine treats them as opaque (no false paths invented).

Resolution is deliberately name-and-type-shaped, not a real type system:
it only ever *adds* edges the source spells out, which is the right
failure mode for a ratcheted gate (a missed edge is a missed finding,
never a false conviction).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .ast_rules import _dotted

# constructor name -> attribute kind tag
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"}
_EVENT_CTORS = {"Event"}
_THREAD_CTORS = {"Thread"}


def _last(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


@dataclass
class LockInfo:
    """One lock-valued attribute or module global."""

    attr: str
    reentrant: bool          # RLock / default Condition re-enter safely
    is_condition: bool = False
    line: int = 0


@dataclass
class ClassEntry:
    path: str
    name: str
    node: ast.ClassDef
    methods: dict[str, list[ast.AST]] = field(default_factory=dict)
    # attr -> ("ClassName", import-resolved module path or None)
    attr_types: dict[str, tuple[str, str | None]] = field(default_factory=dict)
    locks: dict[str, LockInfo] = field(default_factory=dict)
    queue_attrs: set[str] = field(default_factory=set)
    event_attrs: set[str] = field(default_factory=set)
    thread_attrs: set[str] = field(default_factory=set)
    base_names: list[str] = field(default_factory=list)


@dataclass
class ModuleEntry:
    path: str
    dotted: str
    tree: ast.Module
    classes: dict[str, ClassEntry] = field(default_factory=dict)
    functions: dict[str, list[ast.AST]] = field(default_factory=dict)
    # imported name -> ("mod", target_path) | ("sym", target_path, symbol)
    imports: dict[str, tuple] = field(default_factory=dict)
    # module global NAME = ClassName(...) -> (class name, resolved path|None)
    global_types: dict[str, tuple[str, str | None]] = field(
        default_factory=dict)
    global_locks: dict[str, LockInfo] = field(default_factory=dict)


def _path_to_dotted(path: str) -> str:
    p = path[:-3] if path.endswith(".py") else path
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


def _condition_reentrant(call: ast.Call, locks: dict[str, LockInfo]) -> bool:
    """Condition() wraps an RLock by default; Condition(plain_lock) is as
    non-reentrant as the lock it wraps."""
    if not call.args:
        return True
    arg = call.args[0]
    if isinstance(arg, ast.Call):
        return _last(_dotted(arg.func)) == "RLock"
    name = _self_attr(arg)
    if name and name in locks:
        return locks[name].reentrant
    return False


class CallGraph:
    """Index of every analyzed module + best-effort call resolution."""

    def __init__(self, files: dict[str, str],
                 trees: dict[str, ast.Module]):
        self.modules: dict[str, ModuleEntry] = {}
        self.by_dotted: dict[str, str] = {}
        for path in sorted(files):
            entry = ModuleEntry(path=path, dotted=_path_to_dotted(path),
                                tree=trees[path])
            self.modules[path] = entry
            self.by_dotted[entry.dotted] = path
        for entry in self.modules.values():
            self._index_module(entry)

    # -- indexing -----------------------------------------------------------

    def _resolve_module_name(self, importer: ModuleEntry,
                             module: str | None, level: int) -> str | None:
        """Dotted target of an import, anchored at the importing module."""
        if level == 0:
            return module
        # package of the importer: its own dotted name for __init__ files,
        # else the parent
        pkg = importer.dotted
        if not importer.path.endswith("/__init__.py"):
            pkg = pkg.rsplit(".", 1)[0] if "." in pkg else ""
        parts = pkg.split(".") if pkg else []
        if level - 1 > len(parts):
            return None
        base = parts[: len(parts) - (level - 1)]
        if module:
            base.append(module)
        return ".".join(base) if base else None

    def _dotted_to_path(self, dotted: str | None) -> str | None:
        return self.by_dotted.get(dotted) if dotted else None

    def _index_module(self, entry: ModuleEntry) -> None:
        for node in entry.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    target = self._dotted_to_path(a.name)
                    if target:
                        entry.imports[a.asname or a.name.split(".")[0]] = (
                            ("mod", target) if a.asname
                            else ("mod", self._dotted_to_path(
                                a.name.split(".")[0]) or target))
            elif isinstance(node, ast.ImportFrom):
                base = self._resolve_module_name(entry, node.module,
                                                 node.level)
                if base is None:
                    continue
                for a in node.names:
                    # `from pkg import mod` imports a MODULE when pkg.mod
                    # is an analyzed file, a symbol otherwise
                    as_mod = self._dotted_to_path(f"{base}.{a.name}")
                    if as_mod:
                        entry.imports[a.asname or a.name] = ("mod", as_mod)
                        continue
                    sym_mod = self._dotted_to_path(base)
                    if sym_mod:
                        entry.imports[a.asname or a.name] = (
                            "sym", sym_mod, a.name)
        for node in ast.walk(entry.tree):
            if isinstance(node, ast.ClassDef):
                self._index_class(entry, node)
        for node in entry.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                entry.functions.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                ctor = _last(_dotted(node.value.func))
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if ctor in _LOCK_CTORS:
                        entry.global_locks[t.id] = LockInfo(
                            attr=t.id,
                            reentrant=(ctor == "RLock") or (
                                ctor == "Condition"
                                and _condition_reentrant(node.value, {})),
                            is_condition=(ctor == "Condition"),
                            line=node.lineno)
                    else:
                        entry.global_types[t.id] = (
                            ctor, self._ctor_path(entry, node.value.func))

    def _ctor_path(self, entry: ModuleEntry, func: ast.AST) -> str | None:
        """Defining path of a constructor expression, when in-project."""
        d = _dotted(func)
        if not d:
            return None
        head, last = d.split(".")[0], _last(d)
        if head == last:  # bare name: local class or imported symbol
            if last in entry.classes:
                return entry.path
            imp = entry.imports.get(last)
            if imp and imp[0] == "sym":
                return imp[1]
            return None
        imp = entry.imports.get(head)
        if imp and imp[0] == "mod":
            return imp[1]
        return None

    def _index_class(self, entry: ModuleEntry, node: ast.ClassDef) -> None:
        ce = ClassEntry(path=entry.path, name=node.name, node=node,
                        base_names=[_last(_dotted(b)) for b in node.bases])
        entry.classes.setdefault(node.name, ce)
        ce = entry.classes[node.name]
        for sub in node.body:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ce.methods.setdefault(sub.name, []).append(sub)
        # typed attributes: any `self.x = Ctor(...)` anywhere in the class
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Assign)
                    and isinstance(sub.value, ast.Call)):
                continue
            ctor = _last(_dotted(sub.value.func))
            for t in sub.targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                if ctor in _LOCK_CTORS:
                    ce.locks.setdefault(attr, LockInfo(
                        attr=attr,
                        reentrant=(ctor == "RLock") or (
                            ctor == "Condition"
                            and _condition_reentrant(sub.value, ce.locks)),
                        is_condition=(ctor == "Condition"),
                        line=sub.lineno))
                elif ctor in _QUEUE_CTORS:
                    ce.queue_attrs.add(attr)
                elif ctor in _EVENT_CTORS:
                    ce.event_attrs.add(attr)
                elif ctor in _THREAD_CTORS:
                    ce.thread_attrs.add(attr)
                elif ctor and ctor[0].isupper():
                    ce.attr_types.setdefault(attr, (
                        ctor, self._ctor_path(entry, sub.value.func)))
        # annotated attributes: `self.x: Cls = value` anywhere in the class
        for sub in ast.walk(node):
            if isinstance(sub, ast.AnnAssign) and _self_attr(sub.target) is not None:
                ann = _last(_dotted(sub.annotation))
                if ann and ann[0].isupper():
                    ce.attr_types.setdefault(_self_attr(sub.target), (ann, None))
        # annotated-parameter aliasing: `def __init__(self, a: A)` then
        # `self._a = a` types the attribute (collaborator objects are
        # usually handed in, not constructed)
        for defs in ce.methods.values():
            for fn in defs:
                ann: dict[str, str] = {}
                for a in list(fn.args.args) + list(fn.args.kwonlyargs):
                    if a.annotation is None:
                        continue
                    if (isinstance(a.annotation, ast.Constant)
                            and isinstance(a.annotation.value, str)):
                        t = a.annotation.value.strip()
                    else:
                        t = _dotted(a.annotation)
                    t = _last(t).split("[")[0].strip()
                    if t and t[0].isupper():
                        ann[a.arg] = t
                if not ann:
                    continue
                for sub in ast.walk(fn):
                    if not (isinstance(sub, ast.Assign)
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id in ann):
                        continue
                    for t in sub.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            ce.attr_types.setdefault(
                                attr, (ann[sub.value.id], None))

    # -- lookup -------------------------------------------------------------

    def find_class(self, path: str | None, name: str) -> ClassEntry | None:
        """Class ``name`` defined at ``path``; falls back to a unique
        global match when the defining path is unknown."""
        if path is not None:
            entry = self.modules.get(path)
            if entry and name in entry.classes:
                return entry.classes[name]
            return None
        hits = [m.classes[name] for m in self.modules.values()
                if name in m.classes]
        return hits[0] if len(hits) == 1 else None

    def method_defs(self, cls: ClassEntry, name: str,
                    _seen: frozenset = frozenset()) -> list[ast.AST]:
        """Defs of ``cls.name`` following project-resolvable bases."""
        if name in cls.methods:
            return cls.methods[name]
        if cls.name in _seen:
            return []
        entry = self.modules.get(cls.path)
        for base in cls.base_names:
            bce = None
            if entry is not None and base in entry.classes:
                bce = entry.classes[base]
            elif entry is not None:
                imp = entry.imports.get(base)
                if imp and imp[0] == "sym":
                    bce = self.find_class(imp[1], imp[2])
            if bce is not None:
                found = self.method_defs(bce, name,
                                         _seen | {cls.name})
                if found:
                    return found
        return []

    def owner_class(self, path: str, fn: ast.AST) -> ClassEntry | None:
        """ClassEntry whose body (directly) contains ``fn``, if any."""
        entry = self.modules.get(path)
        if entry is None:
            return None
        for ce in entry.classes.values():
            if any(fn in defs for defs in ce.methods.values()):
                return ce
        return None

    def resolve_call(
        self, path: str, cls: ClassEntry | None, call: ast.Call
    ) -> tuple[str, str, ast.AST] | None:
        """-> (defining path, display qualname, function node) or None.

        Multiple same-name defs resolve to the first (collisions across a
        single class/module are rare and the engine's summaries union)."""
        entry = self.modules.get(path)
        if entry is None:
            return None
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            if name in entry.functions:
                return (path, name, entry.functions[name][0])
            if name in entry.classes:  # ClassName(...) runs __init__
                defs = self.method_defs(entry.classes[name], "__init__")
                if defs:
                    return (path, f"{name}.__init__", defs[0])
                return None
            imp = entry.imports.get(name)
            if imp and imp[0] == "sym":
                target = self.modules.get(imp[1])
                if target is None:
                    return None
                if imp[2] in target.functions:
                    return (imp[1], imp[2], target.functions[imp[2]][0])
                if imp[2] in target.classes:
                    defs = self.method_defs(target.classes[imp[2]],
                                            "__init__")
                    if defs:
                        return (imp[1], f"{imp[2]}.__init__", defs[0])
            return None
        if not isinstance(func, ast.Attribute):
            return None
        meth = func.attr
        recv = func.value
        # self.m(...) / self.attr.m(...)
        if isinstance(recv, ast.Name) and recv.id == "self" and cls:
            defs = self.method_defs(cls, meth)
            if defs:
                return (cls.path, f"{cls.name}.{meth}", defs[0])
            return None
        attr = _self_attr(recv)
        if attr is not None and cls is not None:
            typed = cls.attr_types.get(attr)
            if typed:
                tce = self.find_class(typed[1], typed[0])
                if tce:
                    defs = self.method_defs(tce, meth)
                    if defs:
                        return (tce.path, f"{tce.name}.{meth}", defs[0])
            return None
        if isinstance(recv, ast.Name):
            imp = entry.imports.get(recv.id)
            if imp and imp[0] == "mod":
                target = self.modules.get(imp[1])
                if target and meth in target.functions:
                    return (imp[1], meth, target.functions[meth][0])
                if target and meth in target.classes:
                    defs = self.method_defs(target.classes[meth], "__init__")
                    if defs:
                        return (imp[1], f"{meth}.__init__", defs[0])
                return None
            typed = entry.global_types.get(recv.id)
            if typed:
                tce = self.find_class(typed[1], typed[0])
                if tce:
                    defs = self.method_defs(tce, meth)
                    if defs:
                        return (tce.path, f"{tce.name}.{meth}", defs[0])
        return None
