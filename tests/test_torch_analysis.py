"""The port's static-analysis engines (deepfm_tpu_torch/analysis) held to
JAX's (deepfm_tpu/analysis) on the CPU.

* Every carried-over rule (swallowed-exception, guarded-by, the four
  concurrency rules, int32-cast's astype forms, the suppressions and the
  baseline ratchet) gives the same findings through both packages on
  seeded fixtures and their clean counterparts: rule, path, line, col and
  fingerprint.
* Over the port's own tree both packages find nothing, and before the
  suppressions they find the same debt.
* The torch rules (tracer-host-op and traced-nondeterminism inside
  captured bodies, the torch int32 casts) catch their seeded violations
  and leave host code alone.
* The CLI's exit codes, JSON schema and ``--format github`` annotations
  (JAX's lines, escaping and exit codes), and the observability audit of
  the captured bodies.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from deepfm_tpu.analysis import RULES as JAX_RULES
from deepfm_tpu.analysis import baseline as jax_baseline
from deepfm_tpu.analysis import cli as jax_cli
from deepfm_tpu.analysis import run_ast_engine as jax_engine
from deepfm_tpu_torch.analysis import RULES, WAIVED, baseline, cli, run_ast_engine
from deepfm_tpu_torch.analysis.ast_rules import captured_functions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARRIED = {"swallowed-exception", "guarded-by", "int32-cast", "lock-order-cycle",
           "blocking-under-lock", "signal-unsafe-lock", "thread-lifecycle",
           "suppression-missing-reason", "unused-suppression"}


def _key(findings):
    return [(f.rule, f.path, f.line, f.col, f.fingerprint) for f in findings]


# ------------------------------------------------- carried-over rule fixtures

GUARDED = """
import threading

class Swapper:
    def __init__(self):
        self._lock = threading.Lock()
        self.swaps = 0
        self.last_ms = None
        self.log = []

    def status(self):
        with self._lock:
            return {"swaps": self.swaps, "last_ms": self.last_ms, "log": self.log}

    def poll(self, ms):
        {MUTATION}
        with self._lock:
            self.swaps += 1
"""

LOCKED = """
import threading, time, queue, urllib.request

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self._export_lock = threading.Lock()
        self._q = queue.Queue()
        self._cv = threading.Condition()

    def _fetch(self):
        return urllib.request.urlopen("http://localhost:1/x").read()

    def f(self):
        {BODY}
"""

CYCLE = """
import threading

class A:
    def __init__(self):
        self._a = threading.Lock()
        self._b = {KIND}()

    def one(self):
        with self._a:
            with self._b:
                pass

    def two(self):
        with self._b:
            {INNER}
"""

SIGNAL = """
import signal, sys, threading
_lock = threading.{KIND}()
def handler(signum, frame):
    with _lock:
        pass
def normal():
    with _lock:
        pass
{REGISTER}
"""

THREADS = """
import threading
def work():
    {WORK}
class A:
    def __init__(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
    def _run(self):
        pass
    {CLOSE}
def go():
    {GO}
"""

SWALLOW = """
import logging
def f(fn):
    try:
        fn()
    {HANDLER}
"""

INT32 = """
import numpy as np
def f(a, b, x):
    return {EXPR}
"""

SUPPRESSED = """
def f(fn):
    try:
        fn()
    {COMMENT}
    except Exception:
        pass
"""

# name -> (files, rules the case must report, rules it must not)
FIXTURES = {
    "swallowed-pass": ({"m.py": SWALLOW.replace("{HANDLER}", "except Exception:\n        pass")},
                       {"swallowed-exception"}, set()),
    "swallowed-bare": ({"m.py": SWALLOW.replace("{HANDLER}", "except:\n        return None")},
                       {"swallowed-exception"}, set()),
    "swallowed-tuple": ({"m.py": SWALLOW.replace(
        "{HANDLER}", "except (OSError, Exception):\n        pass")}, {"swallowed-exception"}, set()),
    "swallowed-narrow-clean": ({"m.py": SWALLOW.replace(
        "{HANDLER}", "except OSError:\n        pass")}, set(), {"swallowed-exception"}),
    "swallowed-reraise-clean": ({"m.py": SWALLOW.replace(
        "{HANDLER}", "except Exception:\n        raise")}, set(), {"swallowed-exception"}),
    "swallowed-logged-clean": ({"m.py": SWALLOW.replace(
        "{HANDLER}", "except Exception:\n        logging.warning('x')")}, set(),
        {"swallowed-exception"}),
    "swallowed-used-clean": ({"m.py": SWALLOW.replace(
        "{HANDLER}", "except Exception as e:\n        return e")}, set(), {"swallowed-exception"}),
    "guarded-assign": ({"m.py": GUARDED.replace("{MUTATION}", "self.last_ms = ms")},
                       {"guarded-by"}, set()),
    "guarded-append": ({"m.py": GUARDED.replace("{MUTATION}", "self.log.append(ms)")},
                       {"guarded-by"}, set()),
    "guarded-held-clean": ({"m.py": GUARDED.replace(
        "{MUTATION}", "with self._lock:\n            self.last_ms = ms")}, set(), {"guarded-by"}),
    "guarded-acquire-release-clean": ({"m.py": GUARDED.replace(
        "{MUTATION}", "self._lock.acquire()\n        try:\n            self.last_ms = ms\n"
        "        finally:\n            self._lock.release()")}, set(), {"guarded-by"}),
    "guarded-local-clean": ({"m.py": GUARDED.replace("{MUTATION}", "last = ms")}, set(),
                            {"guarded-by"}),
    "blocking-sleep": ({"m.py": LOCKED.replace(
        "{BODY}", "with self._lock:\n            time.sleep(1)")}, {"blocking-under-lock"}, set()),
    "blocking-helper-http": ({"m.py": LOCKED.replace(
        "{BODY}", "with self._lock:\n            return self._fetch()")},
        {"blocking-under-lock"}, set()),
    "blocking-queue-get": ({"m.py": LOCKED.replace(
        "{BODY}", "with self._lock:\n            return self._q.get()")},
        {"blocking-under-lock"}, set()),
    "blocking-cross-module-store": ({
        "pkg/__init__.py": "",
        "pkg/store.py": "def get_store():\n    return None\n\n"
                        "def upload(data):\n    store = get_store()\n"
                        "    store.put('k', data)\n",
        "pkg/m.py": "import threading\nfrom .store import upload\n\nclass B:\n"
                    "    def __init__(self):\n        self._lock = threading.Lock()\n"
                    "    def f(self, d):\n        with self._lock:\n            upload(d)\n"},
        {"blocking-under-lock"}, set()),
    "blocking-sleep-outside-clean": ({"m.py": LOCKED.replace(
        "{BODY}", "with self._lock:\n            x = 1\n        time.sleep(x)")}, set(),
        {"blocking-under-lock"}),
    "blocking-export-lock-clean": ({"m.py": LOCKED.replace(
        "{BODY}", "with self._export_lock:\n            open('/tmp/x').close()")}, set(),
        {"blocking-under-lock"}),
    "blocking-nonblocking-get-clean": ({"m.py": LOCKED.replace(
        "{BODY}", "with self._lock:\n            return self._q.get(block=False)")}, set(),
        {"blocking-under-lock"}),
    "blocking-condition-wait-clean": ({"m.py": LOCKED.replace(
        "{BODY}", "with self._cv:\n            self._cv.wait(1.0)")}, set(),
        {"blocking-under-lock"}),
    "lock-order-opposite": ({"m.py": CYCLE.replace("{KIND}", "threading.Lock").replace(
        "{INNER}", "with self._a:\n                pass")}, {"lock-order-cycle"}, set()),
    "lock-order-self-deadlock": ({"m.py": CYCLE.replace("{KIND}", "threading.Lock").replace(
        "{INNER}", "self.three()\n\n    def three(self):\n        with self._b:\n"
        "            pass")}, {"lock-order-cycle"}, set()),
    "lock-order-rlock-reentry-clean": ({"m.py": CYCLE.replace(
        "{KIND}", "threading.RLock").replace(
        "{INNER}", "self.three()\n\n    def three(self):\n        with self._b:\n"
        "            pass")}, set(), {"lock-order-cycle"}),
    "lock-order-consistent-clean": ({"m.py": CYCLE.replace("{KIND}", "threading.Lock").replace(
        "{INNER}", "pass")}, set(), {"lock-order-cycle"}),
    "signal-plain-lock": ({"m.py": SIGNAL.replace("{KIND}", "Lock").replace(
        "{REGISTER}", "signal.signal(signal.SIGTERM, handler)")}, {"signal-unsafe-lock"}, set()),
    "signal-excepthook": ({"m.py": SIGNAL.replace("{KIND}", "Lock").replace(
        "{REGISTER}", "sys.excepthook = handler")}, {"signal-unsafe-lock"}, set()),
    "signal-rlock-clean": ({"m.py": SIGNAL.replace("{KIND}", "RLock").replace(
        "{REGISTER}", "signal.signal(signal.SIGTERM, handler)")}, set(), {"signal-unsafe-lock"}),
    "signal-stop-callback": ({"m.py": (
        "import threading\nclass W:\n    def __init__(self, guard):\n"
        "        self._lock = threading.Lock()\n"
        "        guard.register_stop_callback(self._on_stop)\n"
        "    def _flush(self):\n        with self._lock:\n            pass\n"
        "    def _on_stop(self):\n        self._flush()\n"
        "    def normal(self):\n        with self._lock:\n            pass\n")},
        {"signal-unsafe-lock"}, set()),
    "thread-never-joined": ({"m.py": THREADS.replace("{WORK}", "pass").replace(
        "{CLOSE}", "").replace("{GO}", "pass")}, {"thread-lifecycle"}, set()),
    "thread-fire-and-forget": ({"m.py": THREADS.replace("{WORK}", "pass").replace(
        "{CLOSE}", "def close(self):\n        self._t.join(timeout=5)").replace(
        "{GO}", "threading.Thread(target=work).start()")}, {"thread-lifecycle"}, set()),
    "thread-daemon-durable": ({"m.py": THREADS.replace(
        "{WORK}", "with open('/tmp/x', 'w') as fh:\n        fh.write('y')").replace(
        "{CLOSE}", "def close(self):\n        self._t.join(timeout=5)").replace(
        "{GO}", "threading.Thread(target=work, daemon=True).start()")},
        {"thread-lifecycle"}, set()),
    "thread-joined-clean": ({"m.py": THREADS.replace("{WORK}", "return 1 + 1").replace(
        "{CLOSE}", "def close(self):\n        self._t.join(timeout=5)").replace(
        "{GO}", "threading.Thread(target=work, daemon=True).start()")}, set(),
        {"thread-lifecycle"}),
    "int32-astype-arith": ({"m.py": INT32.replace("{EXPR}", "(a * b).astype(np.int32)")},
                           {"int32-cast"}, set()),
    "int32-astype-sum": ({"m.py": INT32.replace("{EXPR}", "np.sum(x).astype('int32')")},
                         {"int32-cast"}, set()),
    "int32-clip-after-cast": ({"m.py": INT32.replace(
        "{EXPR}", "np.clip(x.astype(np.int32), 0, a)")}, {"int32-cast"}, set()),
    "int32-clip-before-cast-clean": ({"m.py": INT32.replace(
        "{EXPR}", "np.clip(x, 0, a).astype(np.int32)")}, set(), {"int32-cast"}),
    "int32-floordiv-clean": ({"m.py": INT32.replace("{EXPR}", "(a // b).astype(np.int32)")},
                             set(), {"int32-cast"}),
    "suppression-justified-clean": ({"m.py": SUPPRESSED.replace(
        "{COMMENT}", "# da:allow[swallowed-exception] a probe: failure means absent")},
        set(), {"swallowed-exception", "suppression-missing-reason", "unused-suppression"}),
    "suppression-missing-reason": ({"m.py": SUPPRESSED.replace(
        "{COMMENT}", "# da:allow[swallowed-exception]")}, {"suppression-missing-reason"},
        {"swallowed-exception"}),
    "suppression-wrong-rule": ({"m.py": SUPPRESSED.replace(
        "{COMMENT}", "# da:allow[int32-cast] wrong rule")},
        {"swallowed-exception", "unused-suppression"}, set()),
    "suppression-unused": ({"m.py": "def f():\n    return 1  # da:allow[guarded-by] stale\n"},
                           {"unused-suppression"}, set()),
    "suppression-concurrency-rule": ({"m.py": LOCKED.replace(
        "{BODY}", "with self._lock:\n            # da:allow[blocking-under-lock] the wait is "
        "the point\n            time.sleep(1)")}, set(),
        {"blocking-under-lock", "unused-suppression"}),
    "suppression-in-docstring-clean": ({"m.py": (
        'def f():\n    """Usage: ``x()  # da:allow[guarded-by] why``"""\n    return 1\n')},
        set(), {"unused-suppression", "suppression-missing-reason"}),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_carried_rules_match_jax(name):
    files, must, must_not = FIXTURES[name]
    mine = run_ast_engine(files, concurrency=True)
    theirs = jax_engine(files, concurrency=True)
    assert _key(mine) == _key(theirs), (
        "\n".join(f.render() for f in mine), "\n".join(f.render() for f in theirs))
    assert [f.message for f in mine] == [f.message for f in theirs]
    rules = {f.rule for f in mine}
    assert must <= rules and not (must_not & rules), [f.render() for f in mine]


def test_a_concurrency_suppression_is_not_unused_without_the_flag():
    files = FIXTURES["suppression-concurrency-rule"][0]
    assert run_ast_engine(files) == [] and jax_engine(files) == []


def _ratchet(mod, engine, path):
    """Accept two identical findings, fix one, add a third: the partitions
    each package's baseline gives."""
    two = {"m.py": "def f(g):\n" + "".join(
        f"    try:\n        g({i})\n    except Exception:\n        pass\n" for i in range(2))}
    mod.write_baseline(path, engine(two))
    base = mod.load_baseline(path)
    steps = []
    for n in (2, 1, 3):
        src = {"m.py": "def f(g):\n" + "".join(
            f"    try:\n        g({i})\n    except Exception:\n        pass\n" for i in range(n))}
        new, accepted, stale = mod.partition(engine(src), base)
        steps.append((_key(new), _key(accepted), stale))
    return base, steps


@pytest.mark.parametrize("case", ["count", "schema"])
def test_the_baseline_ratchet_matches_jax(case, tmp_path):
    mine = _ratchet(baseline, run_ast_engine, str(tmp_path / "mine.json"))
    theirs = _ratchet(jax_baseline, jax_engine, str(tmp_path / "theirs.json"))
    if case == "count":
        assert mine[1] == theirs[1]
        (n2, a2, s2), (n1, a1, s1), (n3, a3, s3) = mine[1]
        assert (len(n2), len(a2), s2) == (0, 2, [])
        assert (len(n1), len(a1), len(s1)) == (0, 1, 1)   # fixed one: stale, not new
        assert (len(n3), len(a3), s3) == (1, 2, [])       # a third: new
    else:
        assert mine[0] == theirs[0]
        a = json.loads((tmp_path / "mine.json").read_text())
        b = json.loads((tmp_path / "theirs.json").read_text())
        assert a == b and a["schema"] == baseline.SCHEMA_VERSION == 1


# ------------------------------------------------------------ the port's tree

def _tree_files():
    return cli._collect_files([os.path.join(ROOT, "deepfm_tpu_torch")], ROOT)


def _raw(pkg, files):
    """Engines 1 and 3 before the suppressions, fingerprinted."""
    import importlib

    ast_rules = importlib.import_module(f"{pkg}.analysis.ast_rules")
    guarded = importlib.import_module(f"{pkg}.analysis.guarded_by")
    conc = importlib.import_module(f"{pkg}.analysis.concurrency")
    findings_mod = importlib.import_module(f"{pkg}.analysis.findings")
    trees = ast_rules.parse_files(files)
    out = ast_rules.analyze_modules(files, trees)
    for path, src in sorted(files.items()):
        out += guarded.check_guarded_by(path, src, trees[path])
    out += conc.run_concurrency_engine(files, trees)
    findings_mod.fingerprint_findings(out)
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


def test_both_engines_find_the_same_debt_in_the_port_before_its_suppressions():
    """Over ``deepfm_tpu_torch/`` the carried-over rules flag the same lines
    through both packages (the port's device clause aside), and every one
    of them is covered by a justified ``da:allow``: 15 swallowed
    exceptions (seven of them the shadow worker's and the region layer's,
    with JAX's reasons), 7 blocking calls under a lock (and the 3
    best-effort closes and teardowns that carried their reasons already)."""
    files = _tree_files()
    mine = [f for f in _raw("deepfm_tpu_torch", files)
            if f.rule in CARRIED and "device-dispatch" not in f.message]
    theirs = [f for f in _raw("deepfm_tpu", files) if f.rule in CARRIED]
    assert _key(mine) == _key(theirs)
    assert sorted(f.rule for f in mine) == (["blocking-under-lock"] * 7
                                           + ["swallowed-exception"] * 15)
    extra = [f for f in _raw("deepfm_tpu_torch", files) if f not in mine]
    assert extra == [], [f.render() for f in extra]


def test_jax_s_engines_find_nothing_in_the_port(tmp_path):
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"schema": 1, "findings": {}}))
    out = subprocess.run(
        [sys.executable, "-m", "deepfm_tpu.analysis", "deepfm_tpu_torch/", "--concurrency",
         "--baseline", str(empty)], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new, 0 baselined, 0 stale" in out.stdout


def test_the_port_s_cli_finds_nothing_in_the_port():
    out = subprocess.run(
        [sys.executable, "-m", "deepfm_tpu_torch.analysis", "deepfm_tpu_torch/",
         "--concurrency"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new, 0 baselined, 0 stale" in out.stdout
    assert "engines 1+3" in out.stderr
    stored = json.loads(open(os.path.join(ROOT, cli.DEFAULT_BASELINE)).read())
    assert stored["schema"] == 1 and stored["findings"] == {}


def test_every_jax_rule_is_carried_or_waived_with_a_reason():
    assert set(JAX_RULES) <= set(RULES) | set(WAIVED)
    assert not set(WAIVED) & set(RULES)
    assert "prng-reuse" in WAIVED and "torch.Generator" in WAIVED["prng-reuse"]
    assert all(len(why) > 40 for why in WAIVED.values())


def test_the_captured_set_reaches_the_kernels_through_self_and_imports():
    """The real roots: the train and paged bodies given to StepGraph, the
    serving and funnel bodies from SlotGraphs factories, down through
    ``self._forward``, imports and ``FusedCTR.apply`` to the kernels'
    wrappers."""
    files = _tree_files()
    got = {(p.rsplit("/", 1)[-1], getattr(n, "name", "<lambda>"))
           for p, n in captured_functions(files).fns.values()}
    assert {("step.py", "resident_body"), ("step.py", "paged_body"),
            ("step.py", "lazy_body"), ("graphs.py", "_forward"), ("graphs.py", "retrieve"),
            ("graphs.py", "rank"), ("index.py", "retrieve_with"),
            ("fused_ctr.py", "forward"), ("fused_ctr.py", "backward"),
            ("fused_ctr.py", "_forward_cuda"), ("fused_ctr.py", "fused_ctr_backward"),
            ("sharded.py", "forward")} <= got
    assert ("step.py", "load_scalars") not in got and ("graphs.py", "capture") not in got


# ------------------------------------------------------------ the torch rules

TORCH_FIXTURES = {
    "pkg/__init__.py": "",
    "pkg/graphs.py": '''
import gc
import torch


class StepGraph:
    def __init__(self, body, state, inputs):
        self.body = body


def _capture(body, pool):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        body()
    return graph


class SlotGraphs:
    def __init__(self, device, buckets, fields, out_size, stages, bodies, slots=2):
        self.bodies = bodies
''',
    "pkg/helpers.py": '''
import random
import time


def stamp(x):
    return x * time.perf_counter()


def jitter(x):
    return x + random.random()


def host_only(x):
    return x.item() + time.time()
''',
    "pkg/train.py": '''
import numpy as np
import torch

from .graphs import StepGraph
from .helpers import stamp


def body(state, inputs, scalars):
    loss = state.model(inputs["ids"]).mean()
    n = int(inputs["ids"].shape[0])
    flag = int(inputs["ids"].dtype == torch.int64)
    state.seen = loss.item()
    return {"loss": stamp(loss) * n * flag}


def step(state, inputs):
    if state.graph is None:
        state.graph = StepGraph(body, state, inputs)
    metrics = state.graph(state, inputs)
    return {k: float(v) for k, v in metrics.items()}


def report(metrics):
    return np.mean([v.item() for v in metrics.values()])
''',
    "pkg/serve.py": '''
import datetime

import numpy as np
import torch

from .graphs import SlotGraphs, _capture
from . import helpers


class Predictor:
    def __init__(self, device):
        self._slots = SlotGraphs(device, (8,), 4, lambda b: b, 1, self._bodies)
        self._extra = _capture(lambda: self._tail(), None)

    def _forward(self, ids):
        scores = torch.sigmoid(ids.float())
        if bool(scores.sum() > 0):
            scores = scores + 1
        return helpers.jitter(scores)

    def _bodies(self, slot, st):
        return (lambda: st.out.copy_(self._forward(st.ids)),)

    def _tail(self):
        return np.asarray(datetime.datetime.now().timestamp())

    def predict(self, ids):
        out = self._forward(ids)
        return out.cpu().numpy(), float(out.sum())


def record(graph, x):
    with torch.cuda.graph(graph):
        y = x * 2
        torch.cuda.synchronize()
    return y.tolist()
''',
}

TORCH_EXPECTED = {
    ("pkg/helpers.py", 7, "traced-nondeterminism"),   # stamp, via an import
    ("pkg/helpers.py", 11, "traced-nondeterminism"),  # jitter, via a module alias
    ("pkg/train.py", 13, "tracer-host-op"),           # .item() in the StepGraph body
    ("pkg/serve.py", 18, "tracer-host-op"),           # bool() of a tensor, via self.
    ("pkg/serve.py", 26, "tracer-host-op"),           # np.asarray in the _capture lambda
    ("pkg/serve.py", 26, "traced-nondeterminism"),    # datetime.now there
    ("pkg/serve.py", 36, "tracer-host-op"),           # synchronize under torch.cuda.graph
}


def test_the_torch_rules_catch_captured_host_ops_and_leave_host_code():
    found = {(f.path, f.line, f.rule) for f in run_ast_engine(TORCH_FIXTURES)}
    assert found == TORCH_EXPECTED


TYPED_ATTR_FIXTURES = {
    "pkg/__init__.py": "",
    "pkg/graphs.py": TORCH_FIXTURES["pkg/graphs.py"],
    "pkg/models.py": '''
class Head:
    def logits(self, x):
        raise NotImplementedError


class Wide(Head):
    def logits(self, x):
        return x * x.sum().item()


class Deep(Head):
    def logits(self, x):
        return x + 1
''',
    "pkg/member.py": '''
from .graphs import SlotGraphs
from .models import Head, Wide


def make():
    return Wide()


class Member:
    def __init__(self, device):
        self.head: Head = make()
        self.other = make()
        self._slots = SlotGraphs(device, (8,), 4, lambda b: b, 1, self._bodies)

    def _forward(self, x):
        return self.head.logits(x) + self.other.logits(x)

    def _bodies(self, slot, st):
        return (lambda: st.out.copy_(self._forward(st.ids)),)
''',
}


def test_a_typed_attribute_s_method_reaches_every_override():
    """``self.head: Head = ...`` types the attribute: a captured call of
    ``self.head.logits`` reaches ``Head.logits`` and each project
    subclass's override (a host read in ``Wide.logits`` is found); the
    untyped ``self.other`` stays opaque."""
    found = {(f.path, f.line, f.rule) for f in run_ast_engine(TYPED_ATTR_FIXTURES)}
    assert found == {("pkg/models.py", 9, "tracer-host-op")}
    got = {(p, getattr(n, "name", "<lambda>"))
           for p, n in captured_functions(TYPED_ATTR_FIXTURES).fns.values()}
    assert {("pkg/models.py", "logits"), ("pkg/member.py", "_forward")} <= got
    assert ("pkg/member.py", "make") not in got


@pytest.mark.parametrize("expr, flagged", [
    ("(a * b).to(torch.int32)", True),
    ("x.sum().int()", True),
    ("torch.tensor(a + b, dtype=torch.int32)", True),
    ("(a << 3).type(torch.int32)", True),
    ("x.to(torch.int32).clamp(0, a)", True),
    ("torch.clamp(x.to(dtype=torch.int32), 0, a)", True),
    ("x.clamp(0, a).to(torch.int32)", False),
    ("x.to(torch.int32)", False),
    ("torch.arange(a, dtype=torch.int32)", False),
])
def test_the_torch_int32_casts(expr, flagged):
    src = f"import torch\n\n\ndef f(a, b, x):\n    return {expr}\n"
    rules = [f.rule for f in run_ast_engine({"m.py": src})]
    assert rules == (["int32-cast"] if flagged else [])
    assert jax_engine({"m.py": src}) == []


# ------------------------------------------------------------------- the CLI

def _tree(tmp_path, src: str):
    (tmp_path / ".git").mkdir(exist_ok=True)
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "m.py").write_text(src)
    return str(pkg)


SEEDED = SWALLOW.replace("{HANDLER}", "except Exception:\n        pass")


@pytest.mark.parametrize("case, code", [
    ("clean", 0), ("seeded", 1), ("syntax", 2), ("corrupt-baseline", 2), ("missing-path", 2),
    ("trace-audit-without-card", 2), ("trace-audit-cpu", 1), ("bad-device", 2),
])
def test_cli_exit_codes(case, code, tmp_path, monkeypatch, capsys):
    src = {"clean": "def f():\n    return 1\n", "syntax": "def f(:\n"}.get(case, SEEDED)
    path = _tree(tmp_path, src)
    args = [path]
    if case == "corrupt-baseline":
        (tmp_path / "b.json").write_text("{not json")
        args += ["--baseline", str(tmp_path / "b.json")]
    if case == "missing-path":
        args = [str(tmp_path / "nowhere")]
    if case.startswith("trace-audit") or case == "bad-device":
        import torch

        from deepfm_tpu_torch.analysis import Finding, trace_audit

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(trace_audit, "run_trace_audit", lambda device: [Finding(
            "trace-parity", "deepfm_tpu_torch/train/step.py", 0, 0, f"seeded on {device}",
            source="seeded")])
        (tmp_path / "pkg" / "m.py").write_text("def f():\n    return 1\n")
        args += ["--trace-audit"] + {"trace-audit-cpu": ["--device", "cpu"],
                                     "bad-device": ["--device", "tpu:9"]}.get(case, [])
    assert cli.main(args) == code
    err = capsys.readouterr().err
    if case == "trace-audit-without-card":
        assert "no CUDA device" in err and "--device cpu" in err


def test_cli_json_schema_equals_jax_s(tmp_path, capsys):
    path = _tree(tmp_path, SEEDED)
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"schema": 1, "findings": {}}))
    args = [path, "--format", "json", "--concurrency", "--baseline", str(empty)]
    assert cli.main(args) == 1
    mine = json.loads(capsys.readouterr().out)
    assert jax_cli.main(args) == 1
    theirs = json.loads(capsys.readouterr().out)
    assert mine.keys() == theirs.keys() and mine["counts"] == theirs["counts"]
    assert [sorted(f) for f in mine["new"]] == [sorted(f) for f in theirs["new"]]
    assert mine == theirs


@pytest.mark.parametrize("baselined", [False, True], ids=["new", "baselined"])
def test_cli_github_annotations_equal_jax_s(tmp_path, capsys, monkeypatch, baselined):
    """``--format github`` on one fixture tree (a new finding, or the same
    finding baselined): the port's and JAX's CLIs print the same
    ``::error``/``::notice`` lines and summary, and exit alike.  (JAX's
    renderer binds ``sys.stdout`` when it is defined; it is handed the
    captured one.)"""
    render = jax_cli._render_github
    monkeypatch.setattr(jax_cli, "_render_github",
                        lambda *a, **k: render(*a, out=sys.stdout, **k))
    path = _tree(tmp_path, SEEDED)
    stored = tmp_path / "b.json"
    if baselined:
        baseline.write_baseline(str(stored), run_ast_engine({"pkg/m.py": SEEDED}))
    else:
        stored.write_text(json.dumps({"schema": 1, "findings": {}}))
    args = [path, "--format", "github", "--concurrency", "--baseline", str(stored)]
    code = cli.main(args)
    mine = capsys.readouterr().out.splitlines()
    assert jax_cli.main(args) == code == (0 if baselined else 1)
    theirs = capsys.readouterr().out.splitlines()
    assert mine == theirs
    kind = "::notice" if baselined else "::error"
    assert [line.split(" ", 1)[0] for line in mine] == [kind, "analysis:"]
    assert mine[0].startswith(f"{kind} file=pkg/m.py,line=")
    assert mine[-1] == ("analysis: 0 new, 1 baselined, 0 stale" if baselined
                        else "analysis: 1 new, 0 baselined, 0 stale")


def test_cli_github_on_a_clean_tree_prints_only_the_summary(tmp_path, capsys):
    path = _tree(tmp_path, "def f():\n    return 1\n")
    assert cli.main([path, "--format", "github"]) == 0
    assert capsys.readouterr().out.splitlines() == ["analysis: 0 new, 0 baselined, 0 stale"]


def test_cli_github_escapes_as_jax_s():
    """``%``, CR and LF in the data; ``:`` and ``,`` too in a property (the
    path, the title): JAX's ``_gh_escape``, and the rendered lines equal."""
    import io

    from deepfm_tpu_torch.analysis import Finding

    text = "50% of a:b,c\r\nnext"
    for prop in (False, True):
        assert cli._gh_escape(text, prop=prop) == jax_cli._gh_escape(text, prop=prop)
    assert cli._gh_escape(text) == "50%25 of a:b,c%0D%0Anext"
    assert cli._gh_escape(text, prop=True) == "50%25 of a%3Ab%2Cc%0D%0Anext"
    f = Finding("swallowed-exception", "pkg/a,b:c%.py", 3, 4, "line one\nline 2: 100%",
                hint="fix, then: rerun")
    mine, theirs = io.StringIO(), io.StringIO()
    cli._render_github([f], [f], [], out=mine)
    jax_cli._render_github([f], [f], [], out=theirs)
    assert mine.getvalue() == theirs.getvalue()
    assert mine.getvalue().splitlines()[0] == (
        "::error file=pkg/a%2Cb%3Ac%25.py,line=3,col=4,title=swallowed-exception::"
        "line one%0Aline 2: 100%25  fix: fix, then: rerun")


def test_cli_write_baseline_merges_a_subset_then_runs_green(tmp_path, capsys):
    root = tmp_path
    _tree(root, SEEDED)
    other = root / "other"
    other.mkdir()
    (other / "n.py").write_text(SEEDED)
    assert cli.main([str(root / "pkg"), str(other), "--write-baseline"]) == 0
    stored = root / cli.DEFAULT_BASELINE
    assert len(json.loads(stored.read_text())["findings"]) == 2
    (root / "pkg" / "m.py").write_text("def f():\n    return 1\n")
    assert cli.main([str(root / "pkg"), "--write-baseline"]) == 0  # keeps other/'s
    assert [e["path"] for e in json.loads(stored.read_text())["findings"].values()] == [
        "other/n.py"]
    capsys.readouterr()
    assert cli.main([str(root / "pkg"), str(other)]) == 0
    assert "0 new, 1 baselined, 0 stale" in capsys.readouterr().out


def test_cli_anchors_a_checkout_nested_in_another_repository(tmp_path, monkeypatch, capsys):
    """A checkout without ``.git`` (as ``git archive`` unpacks one) inside a
    directory that has one is its own root: its finding paths start at
    ``deepfm_tpu_torch/``, it reads and writes its own baseline, and the
    enclosing repository's baseline is never read or written."""
    outer = tmp_path / "outer"
    (outer / ".git").mkdir(parents=True)
    decoy = outer / cli.DEFAULT_BASELINE
    decoy.parent.mkdir(parents=True)
    checkout = outer / "scratch" / "final"
    pkg = checkout / "deepfm_tpu_torch"
    (pkg / "analysis").mkdir(parents=True)
    for d in (pkg, pkg / "analysis"):
        (d / "__init__.py").write_text("")
    (pkg / "m.py").write_text(SEEDED)
    findings = run_ast_engine({"deepfm_tpu_torch/m.py": SEEDED})
    assert [f.rule for f in findings] == ["swallowed-exception"]
    baseline.write_baseline(str(decoy), findings)  # would accept the finding if it were read
    decoy_bytes = decoy.read_bytes()
    for cwd in (outer, checkout, pkg / "analysis"):
        monkeypatch.chdir(cwd)
        assert cli.main([str(pkg), "--format", "json"]) == 1
        out = json.loads(capsys.readouterr().out)
        assert [(f["path"], f["fingerprint"]) for f in out["new"]] == [
            ("deepfm_tpu_torch/m.py", findings[0].fingerprint)]
    assert cli.main([str(pkg / "m.py"), "--write-baseline"]) == 0
    own = checkout / cli.DEFAULT_BASELINE
    assert [e["path"] for e in json.loads(own.read_text())["findings"].values()] == [
        "deepfm_tpu_torch/m.py"]
    capsys.readouterr()
    assert cli.main([str(pkg)]) == 0
    assert "0 new, 1 baselined, 0 stale" in capsys.readouterr().out
    assert decoy.read_bytes() == decoy_bytes


# ----------------------------------------------------- the observability audit

def test_the_real_captured_bodies_hold_the_observability_contract():
    from deepfm_tpu_torch.analysis.trace_audit import audit_observability

    assert audit_observability("cpu") == []


@pytest.mark.parametrize("violation", ["counter", "timer"])
def test_a_seeded_observability_violation_is_caught(violation):
    import time

    from deepfm_tpu_torch.analysis.trace_audit import audit_observability
    from deepfm_tpu_torch.obs import MetricsRegistry
    from deepfm_tpu_torch.train.step import resident_body

    if violation == "counter":
        count = MetricsRegistry().counter("predicts_total")

        def counting(predictor):
            def bodies(slot, st):
                def body():
                    count.inc()
                    st.out.copy_(predictor._forward(slot, st.ids, st.vals))
                return (body,)
            return bodies

        findings = audit_observability("cpu", predict_builder=counting)
        assert {f.source for f in findings} == {"obs-predict-instrumented"}
        assert "Counter.inc" in findings[0].message
        return

    def timed(cfg):
        def body(state, batch, scalars):
            metrics = resident_body(state, batch, scalars)
            metrics["loss"] = metrics["loss"] + (time.perf_counter() % 1.0) * 1e-3
            return metrics
        return body

    findings = audit_observability("cpu", step_builder=timed)
    assert {f.source for f in findings} == {
        f"obs-{s}-{k}" for s in ("train-step", "lazy-train-step")
        for k in ("instrumented", "nondeterministic")}
    assert all(f.rule == "trace-observability" for f in findings)
