"""Engine 1 of the port: AST rules that pyflakes cannot express, restated
from ``deepfm_tpu/analysis/ast_rules.py`` with "captured" in place of
"jit-reachable".

A CUDA graph records a body's kernels once, at capture, and replays them
without running its Python again.  So host code inside a captured body
runs once: a host read syncs the capture (``set_sync_debug_mode("error")``
raises on the card, train/step.py ``StepGraph._capture``, serve/graphs.py
``_capture``), and a clock or a python-random value is taken once and
repeated by every replay.  The rules apply only inside captured functions,
so host code keeps its idioms.

**Roots** (per module):

* the function passed to ``StepGraph(body, ...)`` (train/step.py
  ``resident_body``, tiered/step.py ``paged_body``) and to
  ``_capture(body, pool)`` (serve/graphs.py);
* the callables that a ``SlotGraphs(..., bodies, ...)`` factory returns
  (serve/graphs.py ``GraphedPredictor._bodies``, funnel/graphs.py
  ``FunnelGraphs._bodies``; a pool member's ``ShardedPredictor``
  captures through the first);
* the statements under ``with torch.cuda.graph(...)``.

**Propagation** (to a fixpoint): a factory's returned lambdas and inner
defs are captured, a returned call of another function makes that a
factory too, and the function references passed to it are captured; the
nested defs and lambdas of a captured function are captured; a call is
followed through :meth:`.callgraph.CallGraph.resolve_call` (same-module
and imported names, ``self.method`` with the overrides of project
subclasses, typed attributes, module aliases), and further through

* ``Cls.apply(...)`` of a project ``torch.autograd.Function`` subclass:
  its ``forward`` and ``backward`` (ops/fused_ctr.py ``FusedCTR``);
* ``self.attr(...)`` of a typed attribute: the class's ``forward``;
  ``self.attr.meth(...)``: the class's ``meth`` and its project
  subclasses' overrides (an attribute is typed by ``self.attr =
  Cls(...)`` or ``self.attr: Cls = ...``; serve/pool/sharded.py
  ``ShardedCTR.head_model``, a ``CTRModel``, reaches every family's
  ``table_logits``);
* ``self.attr`` where the class set ``self.attr = factory(...)``: the
  factory (funnel/graphs.py ``self._retrieve = build_retrieve_with(ctx)``).

A call of an untyped value (``self._models[slot](ids, vals)``) stays
opaque: a missed edge is a missed finding, never a false one.

A value is *known at capture* when it is a constant, a shape or dtype,
``len()``, a module constant (``torch.int64``), a parameter annotated as a
python number, or arithmetic, comparisons and numpy/math calls of those:
python arithmetic on such values is not a read of a tensor (JAX's
exemption of ``x.shape[...]`` and ``len()``, widened to the port's
annotated host helpers, ops/fused_ctr.py, train/optimizer.py).

**Rules** (ids in findings.RULES): ``tracer-host-op`` (``.item()``,
``.tolist()``, ``.numpy()``, ``.cpu()``; ``float()``/``int()``/``bool()``
of a value not known at capture; numpy calls other than metadata and
arithmetic on values known at capture; a ``synchronize``), ``traced-nondeterminism`` (``time.*``, stdlib
``random.*``, ``np.random.*``, ``datetime.now``), ``int32-cast`` (JAX's
``astype`` forms and the torch ones: ``.to(torch.int32)``, ``.int()``,
``.type(torch.int32)``, ``dtype=torch.int32``; every module, captured or
not) and ``swallowed-exception`` (every module).  JAX's ``prng-reuse`` is
waived (findings.WAIVED).
"""

from __future__ import annotations

import ast

from .findings import Finding

# numpy attribute CALLS that are fine inside a capture (metadata over
# dtypes, not ops over values)
_NP_SAFE_CALLS = {
    "dtype", "iinfo", "finfo", "result_type", "promote_types",
    "broadcast_shapes", "ndim", "issubdtype",
}

_HOST_METHODS = {"item", "tolist", "numpy", "cpu"}

_NONDET_MODULES = {"random"}          # python stdlib random.*
_NONDET_TIME_FNS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
                    "monotonic", "monotonic_ns", "process_time"}
_NONDET_DATETIME_FNS = {"now", "utcnow", "today"}

_INT32_NAMES = {"int32"}
_ACCUM_CALLS = {"sum", "cumsum", "prod", "cumprod", "dot", "matmul",
                "einsum", "tensordot", "vdot"}
_MUTATING_BINOPS = (ast.Add, ast.Mult, ast.Pow, ast.LShift)
_CLIPS = {"clip", "clamp", "clip_", "clamp_"}

# capture entry points: callee name -> (position, keyword) of the body
_CAPTURE_BODY = {"StepGraph": (0, "body"), "_capture": (0, "body")}
# bodies factories: callee name -> (position, keyword) of the factory
_CAPTURE_FACTORY = {"SlotGraphs": (5, "bodies")}

_FN = (ast.FunctionDef, ast.AsyncFunctionDef)
_FN_OR_LAMBDA = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _dotted(node: ast.AST) -> str:
    """'jax.lax.scan' for nested attributes, '' when not a plain path."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _last(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _arg(call: ast.Call, pos: int, kw: str) -> ast.AST | None:
    if len(call.args) > pos:
        return call.args[pos]
    return next((k.value for k in call.keywords if k.arg == kw), None)


def _walk_own(fn: ast.AST):
    """Nodes of ``fn``'s own body: nested defs and lambdas are not entered
    (they are functions of their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FN_OR_LAMBDA + (ast.ClassDef,)):
            stack.extend(ast.iter_child_nodes(node))


# --------------------------------------------------------------------------
# capture reachability
# --------------------------------------------------------------------------

def _is_graph_with(node: ast.AST) -> bool:
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(it.context_expr, ast.Call)
        and _dotted(it.context_expr.func).endswith("cuda.graph") for it in node.items)


class _Scopes:
    """Per module, in one pass: each def or lambda's enclosing function and
    class, and the capture sites (the calls of :data:`_CAPTURE_BODY` and
    :data:`_CAPTURE_FACTORY` names, the ``with torch.cuda.graph`` blocks)
    with theirs."""

    def __init__(self, tree: ast.Module):
        self.parent_fn: dict[int, ast.AST | None] = {}
        self.cls: dict[int, str | None] = {}
        self.sites: list[tuple[ast.AST, ast.AST | None, str | None]] = []
        self._visit(tree, None, None)

    def _visit(self, node: ast.AST, fn, cls) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._visit(child, fn, child.name)
                continue
            if isinstance(child, _FN_OR_LAMBDA):
                self.parent_fn[id(child)] = fn
                self.cls[id(child)] = cls
                self._visit(child, child, cls)
                continue
            if (isinstance(child, ast.Call) and _last(child.func) in
                    _CAPTURE_BODY.keys() | _CAPTURE_FACTORY.keys()) or _is_graph_with(child):
                self.sites.append((child, fn, cls))
            self._visit(child, fn, cls)


class _Captured:
    """The captured functions of a project: roots, then propagation."""

    def __init__(self, graph, trees: dict[str, ast.Module]):
        self.graph = graph
        self.scopes = {p: _Scopes(t) for p, t in trees.items()}
        self.fns: dict[int, tuple[str, ast.AST]] = {}       # id -> (path, node)
        self.regions: list[tuple[str, ast.AST | None, list[ast.stmt]]] = []
        self._factories: set[int] = set()
        self._work: list[tuple[str, ast.AST]] = []
        self._subclasses = self._index_subclasses()
        self._home = {fid: p for p, sc in self.scopes.items() for fid in sc.parent_fn}
        self._assigns: dict[tuple[str, str], dict[str, list[ast.AST]]] = {}
        self._attrs_done: set[tuple[str, str, str]] = set()
        for path in sorted(trees):
            for node, scope, cls_name in self.scopes[path].sites:
                entry = self.graph.modules[path]
                self._root_node(path, scope, entry.classes.get(cls_name) if cls_name
                                else None, node)
        while self._work:
            self._propagate(*self._work.pop())

    # -- helpers -------------------------------------------------------------

    def _resolve_class(self, path: str, name: str):
        """The project class ``name`` denotes in module ``path``: defined
        there or imported by name."""
        entry = self.graph.modules.get(path)
        if entry is None:
            return None
        if name in entry.classes:
            return entry.classes[name]
        imp = entry.imports.get(name)
        if imp and imp[0] == "sym":
            return self.graph.find_class(imp[1], imp[2])
        return None

    def _index_subclasses(self) -> dict[tuple[str, str], list]:
        out: dict[tuple[str, str], list] = {}
        for entry in self.graph.modules.values():
            for ce in entry.classes.values():
                for base in ce.base_names:
                    bce = self._resolve_class(entry.path, base)
                    if bce is not None:
                        out.setdefault((bce.path, bce.name), []).append(ce)
        return out

    def _class(self, path: str, node: ast.AST):
        name = self.scopes[path].cls.get(id(node))
        entry = self.graph.modules.get(path)
        return entry.classes.get(name) if (entry and name) else None

    def _capture(self, path: str, node: ast.AST) -> None:
        if id(node) not in self.fns:
            self.fns[id(node)] = (path, node)
            self._work.append((path, node))

    def _methods(self, cls, name: str, seen=None) -> list:
        """``cls.name`` and the overrides of every project subclass."""
        seen = seen if seen is not None else set()
        if cls is None or (cls.path, cls.name) in seen:
            return []
        seen.add((cls.path, cls.name))
        out = list(self.graph.method_defs(cls, name))
        for sub in self._subclasses.get((cls.path, cls.name), []):
            out += [d for d in self._methods(sub, name, seen) if d not in out]
        return out

    def _local_def(self, path: str, scope: ast.AST | None, name: str):
        """The def ``name`` visible from ``scope``: nested in it or in an
        enclosing function, else a module function or an imported one."""
        while scope is not None:
            for node in _walk_own(scope):
                if isinstance(node, _FN) and node.name == name:
                    return path, node
            scope = self.scopes[path].parent_fn.get(id(scope))
        entry = self.graph.modules[path]
        if name in entry.functions:
            return path, entry.functions[name][0]
        imp = entry.imports.get(name)
        if imp and imp[0] == "sym":
            target = self.graph.modules.get(imp[1])
            if target and imp[2] in target.functions:
                return imp[1], target.functions[imp[2]][0]
        return None

    def _attr_sources(self, cls, attr: str) -> list[tuple]:
        """(class, value) of each ``self.attr = value`` of ``cls`` and its
        project bases."""
        out = []
        for c in [cls] + self._bases(cls):
            assigns = self._assigns.get((c.path, c.name))
            if assigns is None:
                assigns = self._assigns[(c.path, c.name)] = {}
                for node in ast.walk(c.node):
                    if isinstance(node, ast.Assign):
                        for t in node.targets:
                            if _self_attr(t) is not None:
                                assigns.setdefault(t.attr, []).append(node.value)
            out += [(c, v) for v in assigns.get(attr, ())]
        return out

    def _bases(self, cls) -> list:
        out = []
        for base in cls.base_names:
            bce = self._resolve_class(cls.path, base)
            if bce is not None:
                out += [bce] + self._bases(bce)
        return out

    # -- callable expressions ------------------------------------------------

    def _callable(self, path: str, scope, cls, expr: ast.AST) -> None:
        """Capture what ``expr`` (a body handed to a capture) denotes."""
        if isinstance(expr, ast.Lambda):
            self._capture(path, expr)
        elif isinstance(expr, ast.Name):
            found = self._local_def(path, scope, expr.id)
            if found:
                self._capture(*found)
        elif isinstance(expr, ast.Call):
            owner = self._constructed(path, cls, expr)
            if owner is not None:  # a module instance: the capture calls it
                for meth in ("forward", "__call__"):
                    for fn in self.graph.method_defs(owner, meth):
                        self._capture(owner.path, fn)
            else:
                self._factory_call(path, scope, cls, expr)
        elif _self_attr(expr) is not None and cls is not None:
            attr = _self_attr(expr)
            for fn in self._methods(cls, attr):
                self._capture(self._home[id(fn)], fn)
            self._attr_factories(cls, attr)

    def _typed_receiver(self, cls, func: ast.AST):
        """The project class of ``self.attr`` in a call ``self.attr.meth(...)``
        when ``cls`` types ``attr``, else None."""
        if cls is None or not isinstance(func, ast.Attribute):
            return None
        attr = _self_attr(func.value)
        typed = cls.attr_types.get(attr) if attr is not None else None
        return self.graph.find_class(typed[1], typed[0]) if typed else None

    def _constructed(self, path: str, cls, call: ast.Call):
        """The project class ``call`` constructs, if it is one."""
        got = self.graph.resolve_call(path, cls, call)
        if got is None or not got[1].endswith(".__init__"):
            return None
        return self.graph.find_class(got[0], got[1].rsplit(".", 1)[0])

    def _attr_factories(self, cls, attr: str) -> None:
        key = (cls.path, cls.name, attr)
        if key in self._attrs_done:
            return
        self._attrs_done.add(key)
        for owner, value in self._attr_sources(cls, attr):
            for node in ast.walk(value):
                if isinstance(node, ast.Call):
                    self._factory_call(owner.path, None, owner, node)
                elif isinstance(node, ast.Name) and node is value:
                    found = self._local_def(owner.path, None, node.id)
                    if found:
                        self._capture(*found)

    def _factory_call(self, path: str, scope, cls, call: ast.Call) -> None:
        """``call``'s callee is a factory: what it returns is captured."""
        self._factory_ref(path, scope, cls, call.func, call)

    def _factory_ref(self, path: str, scope, cls, expr: ast.AST,
                     call: ast.Call | None = None) -> None:
        """``expr`` names a factory (a def in scope, ``self.method`` and its
        overrides, or what ``call`` resolves to)."""
        if isinstance(expr, ast.Name):
            found = self._local_def(path, scope, expr.id)
            if found:
                self._factory(*found)
        elif _self_attr(expr) is not None and cls is not None:
            for fn in self._methods(cls, _self_attr(expr)):
                self._factory(self._home[id(fn)], fn)
        elif call is not None:
            got = self.graph.resolve_call(path, cls, call)
            if got:
                self._factory(got[0], got[2])

    def _factory(self, path: str, fn: ast.AST) -> None:
        if id(fn) in self._factories:
            return
        self._factories.add(id(fn))
        cls = self._class(path, fn)
        for node in _walk_own(fn):
            if not (isinstance(node, ast.Return) and node.value is not None):
                continue
            vals = (node.value.elts if isinstance(node.value, (ast.Tuple, ast.List))
                    else [node.value])
            for v in vals:
                self._callable(path, fn, cls, v)
                if isinstance(v, ast.Call):
                    for a in list(v.args) + [k.value for k in v.keywords]:
                        if isinstance(a, (ast.Lambda, ast.Name)) or (
                                _self_attr(a) is not None):
                            self._callable(path, fn, cls, a)

    # -- roots and propagation -----------------------------------------------

    def _root_node(self, path: str, scope, cls, node: ast.AST) -> None:
        if isinstance(node, ast.Call):
            name = _last(node.func)
            if name in _CAPTURE_BODY:
                body = _arg(node, *_CAPTURE_BODY[name])
                if body is not None:
                    self._callable(path, scope, cls, body)
            elif name in _CAPTURE_FACTORY:
                factory = _arg(node, *_CAPTURE_FACTORY[name])
                if isinstance(factory, ast.Call):
                    self._factory_call(path, scope, cls, factory)
                elif factory is not None:
                    self._factory_ref(path, scope, cls, factory)
        elif _is_graph_with(node):
            self.regions.append((path, scope, node.body))
            region = ast.Module(body=node.body, type_ignores=[])
            self._propagate(path, region, scope=scope, cls=cls)

    def _propagate(self, path: str, fn: ast.AST, scope=None, cls=None) -> None:
        """Capture what the captured ``fn`` (or a ``with`` region) reaches."""
        if scope is None:
            scope, cls = fn, self._class(path, fn)
        for node in _walk_own(fn):
            if isinstance(node, _FN_OR_LAMBDA):
                self._capture(path, node)
            elif isinstance(node, ast.Call):
                self._follow(path, scope, cls, node)
            elif (isinstance(node, ast.Attribute) and cls is not None
                    and _self_attr(node) is not None
                    and isinstance(node.ctx, ast.Load)):
                self._attr_factories(cls, node.attr)

    def _follow(self, path: str, scope, cls, call: ast.Call) -> None:
        func = call.func
        if isinstance(func, ast.Name):
            found = self._local_def(path, scope, func.id)
            if found:
                self._capture(*found)
                return
        typed = self._typed_receiver(cls, func)
        if typed is not None:  # self.attr.meth(...): the class's and its subclasses'
            for fn in self._methods(typed, func.attr):
                self._capture(self._home[id(fn)], fn)
            return
        got = self.graph.resolve_call(path, cls, call)
        if got is not None:
            tpath, _, node = got
            self._capture(tpath, node)
            attr = _self_attr(func)
            if attr is not None and cls is not None:
                for fn in self._methods(cls, attr):
                    self._capture(self._home[id(fn)], fn)
            return
        if (isinstance(func, ast.Attribute) and func.attr == "apply"
                and isinstance(func.value, ast.Name)):
            owner = self._resolve_class(path, func.value.id)
            if owner is not None:
                for meth in ("forward", "backward"):
                    for fn in self.graph.method_defs(owner, meth):
                        self._capture(owner.path, fn)
        attr = _self_attr(func)
        if attr is not None and cls is not None:
            typed = cls.attr_types.get(attr)
            tce = self.graph.find_class(typed[1], typed[0]) if typed else None
            if tce is not None:
                for fn in self.graph.method_defs(tce, "forward"):
                    self._capture(tce.path, fn)


# --------------------------------------------------------------------------
# per-rule checks
# --------------------------------------------------------------------------

def _src_line(src_lines: list[str], lineno: int) -> str:
    return src_lines[lineno - 1] if 0 < lineno <= len(src_lines) else ""


_SCALAR_ANNOTATIONS = {"int", "float", "bool", "complex"}
_CONSTANT_MODULES = ("torch", "np", "numpy", "math")


def _scalar_params(fn: ast.AST) -> frozenset[str]:
    """Parameters annotated as python numbers: known at capture."""
    args = getattr(fn, "args", None)
    if args is None:
        return frozenset()
    return frozenset(
        a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
        if a.annotation is not None and _dotted(a.annotation) in _SCALAR_ANNOTATIONS)


def _static_at_trace(expr: ast.AST, scalars: frozenset[str] = frozenset()) -> bool:
    """A python value at capture, not a tensor's: constants, shapes and
    dtypes, ``len()``, module constants (``torch.int64``), parameters
    annotated as python numbers, and arithmetic, comparisons and
    numpy/math calls of those."""
    def static(e: ast.AST) -> bool:
        return _static_at_trace(e, scalars)

    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in scalars
    if isinstance(expr, ast.Attribute):
        return (expr.attr in ("shape", "ndim", "size", "dtype")
                or _dotted(expr).split(".", 1)[0] in _CONSTANT_MODULES)
    if isinstance(expr, ast.Subscript):
        return static(expr.value)
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Name):
            return expr.func.id == "len" or (
                expr.func.id in ("float", "int", "bool") and all(map(static, expr.args)))
        return (_dotted(expr.func).split(".", 1)[0] in ("np", "numpy", "math")
                and all(map(static, expr.args))
                and all(static(k.value) for k in expr.keywords))
    if isinstance(expr, ast.BinOp):
        return static(expr.left) and static(expr.right)
    if isinstance(expr, ast.UnaryOp):
        return static(expr.operand)
    if isinstance(expr, ast.Compare):
        return static(expr.left) and all(map(static, expr.comparators))
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(map(static, expr.elts))
    return False


def _check_captured_body(path: str, name: str, nodes, src_lines: list[str],
                         out: list[Finding], scalars: frozenset[str] = frozenset()
                         ) -> None:
    """tracer-host-op + traced-nondeterminism over one captured function's
    own nodes (its nested defs are checked as functions of their own);
    ``scalars``: its parameters annotated as python numbers."""

    def add(rule, node, message, hint):
        out.append(Finding(rule=rule, path=path, line=node.lineno,
                           col=node.col_offset, message=message, hint=hint,
                           source=_src_line(src_lines, node.lineno)))

    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id in ("float", "int", "bool"):
            if node.args and not _static_at_trace(node.args[0], scalars):
                add("tracer-host-op", node,
                    f"{node.func.id}() on a value inside captured '{name}' "
                    f"reads the tensor on the host (a sync inside the capture, "
                    f"or a value frozen into the graph)",
                    "keep the value on the card (torch ops) or compute it "
                    "before the capture and pass it in a static buffer")
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        d = _dotted(node.func)
        root = d.split(".", 1)[0] if d else ""
        attr = node.func.attr
        if attr in _HOST_METHODS and not node.args and not node.keywords:
            add("tracer-host-op", node,
                f".{attr}() inside captured '{name}' copies a tensor to the "
                f"host: the capture syncs (and raises under "
                f"set_sync_debug_mode('error'))",
                "return the tensor and read it after the replay, outside "
                "the captured body")
        elif attr == "synchronize":
            add("tracer-host-op", node,
                f"{d or '.synchronize'}() inside captured '{name}' waits for "
                f"the card during the capture",
                "synchronize after the replay, outside the captured body")
        elif (root in ("np", "numpy") and attr not in _NP_SAFE_CALLS
              and not d.startswith(("np.random.", "numpy.random."))
              and not _static_at_trace(node, scalars)):
            add("tracer-host-op", node,
                f"numpy call {d}() inside captured '{name}' runs on the "
                f"host, once, at capture",
                "use the torch equivalent on the card")
        elif root == "time" and attr in _NONDET_TIME_FNS:
            add("traced-nondeterminism", node,
                f"time.{attr}() inside captured '{name}' is read once, at "
                f"capture, and every replay repeats it",
                "pass timestamps in through a static buffer")
        elif root in _NONDET_MODULES or d.startswith(("np.random.", "numpy.random.")):
            add("traced-nondeterminism", node,
                f"{d}() inside captured '{name}' draws once, at capture — "
                f"every replay repeats the 'random' value",
                "draw with torch on the card from a generator registered "
                "with the graph")
        elif root == "datetime" and attr in _NONDET_DATETIME_FNS:
            add("traced-nondeterminism", node,
                f"datetime.{attr}() inside captured code",
                "pass timestamps in through a static buffer")


def _is_int32_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "int32":
        return True
    d = _dotted(node)
    return bool(d) and d.rsplit(".", 1)[-1] in _INT32_NAMES


def _is_risky(val: ast.AST) -> bool:
    return (isinstance(val, ast.BinOp) and isinstance(val.op, _MUTATING_BINOPS)) or (
        isinstance(val, ast.Call)
        and _dotted(val.func).rsplit(".", 1)[-1] in _ACCUM_CALLS)


def _cast_operand(call: ast.AST) -> tuple[str, ast.AST] | None:
    """(form, operand) when ``call`` narrows its operand to int32:
    ``x.astype(int32)`` (JAX's form), ``x.to(torch.int32)``,
    ``x.type(torch.int32)``, ``x.int()``, or ``f(x, dtype=torch.int32)``."""
    if not isinstance(call, ast.Call):
        return None
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr == "astype" and call.args and _is_int32_dtype(call.args[0]):
            return "astype", func.value
        if func.attr in ("to", "type"):
            dtype = _arg(call, 0, "dtype")
            if dtype is not None and _is_int32_dtype(dtype):
                return f".{func.attr}(torch.int32)", func.value
        if func.attr == "int" and not call.args and not call.keywords:
            return ".int()", func.value
    dtype = next((k.value for k in call.keywords if k.arg == "dtype"), None)
    if dtype is not None and call.args and _is_int32_dtype(dtype):
        return "dtype=int32", call.args[0]
    return None


def _check_int32_cast(
    path: str, tree: ast.AST, src_lines: list[str], out: list[Finding]
) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        cast = _cast_operand(node)
        if cast is not None and _is_risky(cast[1]):
            if cast[0] == "astype":  # JAX's wording, so the findings agree
                message = ("astype(int32) of an arithmetic result — the "
                           "product/sum can exceed 2**31-1 and wrap silently")
            else:
                message = (f"{cast[0]} of an arithmetic result — the "
                           f"product/sum can exceed 2**31-1 and wrap silently")
            out.append(Finding(
                rule="int32-cast", path=path,
                line=node.lineno, col=node.col_offset, message=message,
                hint="bound the value first (clip / guard the operand "
                     "ranges) or keep the accumulation in int64",
                source=_src_line(src_lines, node.lineno),
            ))
        # clip(X.astype(int32), ...) / X.to(torch.int32).clamp(...): the
        # cast runs before the clip, so the clip bounds a wrapped value
        clipped = None
        last = _dotted(node.func).rsplit(".", 1)[-1]
        if last in _CLIPS and node.args and _cast_operand(node.args[0]):
            clipped = node.args[0]
        elif (isinstance(node.func, ast.Attribute) and node.func.attr in _CLIPS
                and _cast_operand(node.func.value)):
            clipped = node.func.value
        if clipped is not None:
            if _cast_operand(clipped)[0] == "astype":
                message = ("clip applied AFTER astype(int32): a >=2**31 input has "
                           "already wrapped to an arbitrary in-range value the "
                           "clip will happily keep")
                hint = "clip in the wide dtype, then cast: x.clip(lo, hi).astype(int32)"
            else:
                message = ("clamp applied AFTER the int32 cast: a >=2**31 input "
                           "has already wrapped to an arbitrary in-range value "
                           "the clamp will happily keep")
                hint = ("clamp in the wide dtype, then cast: "
                        "x.clamp(lo, hi).to(torch.int32)")
            out.append(Finding(
                rule="int32-cast", path=path,
                line=node.lineno, col=node.col_offset, message=message, hint=hint,
                source=_src_line(src_lines, node.lineno),
            ))


_LOGGING_HINTS = {"warning", "error", "exception", "critical", "info",
                  "debug", "log", "print_exc", "print_exception", "print"}


def _check_swallowed(
    path: str, tree: ast.AST, src_lines: list[str], out: list[Finding]
) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        t = node.type

        def _is_broad(tp: ast.AST | None) -> bool:
            if tp is None:
                return True
            if isinstance(tp, ast.Tuple):  # except (Exception, X): ...
                return any(_is_broad(e) for e in tp.elts)
            return (isinstance(tp, (ast.Name, ast.Attribute))
                    and _dotted(tp).rsplit(".", 1)[-1]
                    in ("Exception", "BaseException"))

        if not _is_broad(t):
            continue
        reraises = any(isinstance(n, ast.Raise) for n in ast.walk(node))
        uses_exc = node.name is not None and any(
            isinstance(n, ast.Name) and n.id == node.name
            for b in node.body for n in ast.walk(b)
        )
        logs = any(
            isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Name) and n.func.id in _LOGGING_HINTS)
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr in _LOGGING_HINTS)
            )
            for b in node.body for n in ast.walk(b)
        )
        if not (reraises or uses_exc or logs):
            if t is None:
                caught = "bare except"
            elif isinstance(t, ast.Tuple):
                caught = ("except ("
                          + ", ".join(_dotted(e) or "?" for e in t.elts) + ")")
            else:
                caught = f"except {_dotted(t)}"
            out.append(Finding(
                rule="swallowed-exception", path=path,
                line=node.lineno, col=node.col_offset,
                message=(
                    f"{caught} swallows the error (no re-raise, no log, "
                    f"exception unused) — a retry/breaker/swap path failing "
                    f"here vanishes"
                ),
                hint="narrow the exception type, log it, or suppress with "
                     "a justified da:allow[swallowed-exception]",
                source=_src_line(src_lines, node.lineno),
            ))


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def parse_files(files: dict[str, str]) -> dict[str, ast.Module]:
    """Parse once for every engine-1 pass (ast rules AND guarded-by) and
    engine 3."""
    trees = {}
    for path, src in sorted(files.items()):
        try:
            trees[path] = ast.parse(src, filename=path)
        except SyntaxError as e:
            raise ValueError(f"{path}: syntax error: {e}") from e
    return trees


def captured_functions(files: dict[str, str], trees: dict[str, ast.Module] | None = None,
                       graph=None) -> _Captured:
    """The captured functions and ``with torch.cuda.graph`` regions of
    ``files`` (module docstring)."""
    from .callgraph import CallGraph

    trees = parse_files(files) if trees is None else trees
    return _Captured(graph if graph is not None else CallGraph(files, trees), trees)


def analyze_modules(files: dict[str, str], trees: dict[str, ast.Module] | None = None,
                    graph=None) -> list[Finding]:
    """{repo-relative path: source} -> findings (engine 1, minus guarded-by
    which lives in guarded_by.py).  Pass ``trees`` (from
    :func:`parse_files`) and ``graph`` (a :class:`.callgraph.CallGraph`)
    to avoid building them again."""
    trees = parse_files(files) if trees is None else trees
    captured = captured_functions(files, trees, graph)
    lines = {path: src.splitlines() for path, src in files.items()}
    out: list[Finding] = []
    for path, fn in sorted(captured.fns.values(),
                           key=lambda pf: (pf[0], pf[1].lineno, pf[1].col_offset)):
        name = getattr(fn, "name", "<lambda>")
        _check_captured_body(path, name, _walk_own(fn), lines[path], out,
                             _scalar_params(fn))
    for path, scope, body in captured.regions:
        region = ast.Module(body=body, type_ignores=[])
        name = f"with torch.cuda.graph in {getattr(scope, 'name', '<module>')}"
        _check_captured_body(path, name, _walk_own(region), lines[path], out)
    for path in sorted(files):
        _check_int32_cast(path, trees[path], lines[path], out)
        _check_swallowed(path, trees[path], lines[path], out)
    return out
