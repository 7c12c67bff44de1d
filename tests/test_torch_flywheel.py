"""The port's flywheel (deepfm_tpu_torch/flywheel, online/stream.py
SegmentWriter, fleet/split.py) against the JAX package's on the same
files: segment writers and record codecs byte-equal, the sampling gate
equal on 10,000 ids, and the delayed-label join's output segments and
state file byte-equal to JAX's over the same input directories, in every
case of the JAX join tests and after a kill at every checkpoint boundary
and a resume; the flywheel config's validation; feedback-train's dispatch
to the online trainer; the join's module CLI."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.core.config import FlywheelConfig as JaxFlywheelConfig
from deepfm_tpu.flywheel import JoinService as JaxJoinService
from deepfm_tpu.flywheel import impression_sampled as jax_sampled
from deepfm_tpu.flywheel import records as jax_records
from deepfm_tpu.flywheel.join import main as jax_join_main
from deepfm_tpu.online import SegmentWriter as JaxSegmentWriter
from deepfm_tpu_torch.core.config import Config, FlywheelConfig, RegionsConfig
from deepfm_tpu_torch.data.example_proto import parse_example, serialize_ctr_example
from deepfm_tpu_torch.data.tfrecord import frame_record, read_records
from deepfm_tpu_torch.fleet.split import split_point
from deepfm_tpu_torch.flywheel import (JoinService, impression_sampled, parse_click,
                                       parse_impression, serialize_click, serialize_impression)
from deepfm_tpu_torch.flywheel.join import STATE_NAME, load_state, load_status
from deepfm_tpu_torch.flywheel.join import main as join_main
from deepfm_tpu_torch.online.stream import (DirectoryTail, EventLogReader, SegmentWriter,
                                            StreamCursor, append_segment, open_tail,
                                            publish_segment, segment_name)

ROOT = Path(__file__).resolve().parent.parent
FIELD = 4
T0 = 1_700_000_000.0  # fixed epoch base for segment publish times


def _ids_at(rate: float, keep: bool, n: int, prefix: str = "req") -> list:
    out, i = [], 0
    while len(out) < n:
        cand = f"{prefix}{i}"
        if impression_sampled(cand, rate) == keep:
            out.append(cand)
        i += 1
    return out


def _imp_record(pid: str, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return serialize_impression(
        impression_id=pid, trace_id=pid.rsplit("#", 1)[0], tenant="base",
        model_version=3, ids=rng.integers(0, 50, FIELD).tolist(),
        values=rng.random(FIELD).astype(np.float32).tolist(),
        score=0.5, deadline_class="default", ts_ms=int(T0 * 1000))


def _publish(root: str, seq: int, records: list, mtime: float) -> str:
    name = publish_segment(root, segment_name(seq), b"".join(frame_record(r) for r in records))
    os.utime(os.path.join(root, name), (mtime, mtime))
    return name


def _read_segments(root) -> dict:
    """{file name: raw bytes} of every segment and the state file: the
    byte-exact comparison unit."""
    root = str(root)
    tail = open_tail(root)
    out = {}
    for name in tail.list_segments():
        with tail.open_segment(name) as f:
            out[name] = f.read()
    state = os.path.join(root, STATE_NAME)
    if os.path.exists(state):
        out[STATE_NAME] = Path(state).read_bytes()
    return out


def _emitted(root) -> list:
    rows = []
    tail = open_tail(str(root))
    for name in tail.list_segments():
        with tail.open_segment(name) as f:
            for rec in read_records(f):
                doc = parse_example(rec)
                rows.append((doc["label"][0], list(doc["ids"])))
    return rows


class _Logs:
    """One impression log and one click log with set publish times."""

    def __init__(self, tmp_path):
        self.imp = str(tmp_path / "imps")
        self.click = str(tmp_path / "clicks")
        os.makedirs(self.imp)
        os.makedirs(self.click)
        self._imp_seq = self._click_seq = 0

    def imps(self, pids, at, seed=0):
        _publish(self.imp, self._imp_seq,
                 [_imp_record(p, seed=seed + i) for i, p in enumerate(pids)], T0 + at)
        self._imp_seq += 1

    def clicks(self, pids, at):
        _publish(self.click, self._click_seq,
                 [serialize_click(impression_id=p, ts_ms=int((T0 + at) * 1000)) for p in pids],
                 T0 + at)
        self._click_seq += 1


def _both(logs, tmp_path, name: str, run_kw: dict | None = None, **kw):
    """The port's and JAX's join over the same input directories, each
    into its own output: (port service, JAX service, port dir, JAX dir)."""
    kw.setdefault("attribution_window_secs", 10.0)
    run_kw = run_kw if run_kw is not None else {"drain_at_eof": True}
    out_p, out_j = tmp_path / f"{name}_port", tmp_path / f"{name}_jax"
    port = JoinService(logs.imp, logs.click, str(out_p), **kw)
    jax = JaxJoinService(logs.imp, logs.click, str(out_j), **kw)
    assert port.run(**run_kw) == jax.run(**run_kw)
    return port, jax, out_p, out_j


def _same_stats(port, jax) -> dict:
    sp, sj = port.stats(), jax.stats()
    sp.pop("lag_seconds"), sj.pop("lag_seconds")
    assert sp == sj
    return sp


# ------------------------------------------------------------ SegmentWriter


def test_segment_writer_rolls_like_jax_and_its_segments_are_byte_equal(tmp_path):
    records = [serialize_ctr_example(float(i % 2), [i] * FIELD, [0.5] * FIELD)
               for i in range(20)]
    port = SegmentWriter(str(tmp_path / "p"), roll_bytes=150, roll_age_secs=0)
    jax = JaxSegmentWriter(str(tmp_path / "j"), roll_bytes=150, roll_age_secs=0)
    names = [(port.append(r), jax.append(r)) for r in records]
    assert all(a == b for a, b in names) and any(a for a, _ in names)
    assert port.flush() == jax.flush()
    a, b = _read_segments(tmp_path / "p"), _read_segments(tmp_path / "j")
    assert len(a) >= 2 and a == b
    got = []
    for name in sorted(a):
        with open(tmp_path / "p" / name, "rb") as f:
            got.extend(read_records(f))
    assert got == records


def test_segment_writer_age_roll_explicit_flush_and_seq(tmp_path):
    clock = [100.0]
    w = SegmentWriter(str(tmp_path / "age"), roll_bytes=0, roll_age_secs=5.0,
                      clock=lambda: clock[0])
    assert w.append(b"x" * 16) is None and w.poll() is None
    clock[0] += 5.0
    assert w.poll() == segment_name(0) and w.pending_records == 0
    w = SegmentWriter(str(tmp_path / "off"), roll_bytes=0, roll_age_secs=0)
    for _ in range(50):
        assert w.append(b"r" * 100) is None
    assert w.poll() is None and open_tail(str(tmp_path / "off")).list_segments() == []
    assert w.flush() == segment_name(0) and w.flush() is None
    assert (w.segments_published_total, w.records_published_total) == (1, 50)
    root = str(tmp_path / "seq")
    zeros = np.zeros((4, FIELD), np.int64)
    append_segment(root, np.zeros(4, np.float32), zeros, zeros.astype(np.float32), seq=0)
    append_segment(root, np.zeros(4, np.float32), zeros, zeros.astype(np.float32), seq=1)
    w = SegmentWriter(root, roll_bytes=0, roll_age_secs=0)
    assert w.next_seq == 2
    w.append(serialize_ctr_example(1.0, [1] * FIELD, [1.0] * FIELD))
    assert w.flush() == segment_name(2)
    batch, cursor = list(EventLogReader(DirectoryTail(root), field_size=FIELD,
                                        batch_size=16).batches())[0]
    assert batch["label"].tolist() == [0.0] * 8 + [1.0]
    assert cursor == StreamCursor(segment_name(2), 1)


# ------------------------------------------------------- records + sampling


def test_records_are_byte_equal_to_jax_and_round_trip():
    kw = dict(impression_id="abc#1", trace_id="abc", tenant="base", model_version=7,
              ids=[3, 1, 4, 1], values=[0.1, 0.2, 0.3, 0.4], score=0.625,
              deadline_class="deadline", ts_ms=1234567890123)
    rec = serialize_impression(**kw)
    assert rec == jax_records.serialize_impression(**kw)
    imp, want = parse_impression(rec), jax_records.parse_impression(rec)
    assert imp.impression_id == "abc#1" and imp.ts_ms == 1234567890123
    assert imp.ids.tolist() == [3, 1, 4, 1] and imp.model_version == 7
    for got, ref in zip(imp, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    click = serialize_click(impression_id="abc#1", ts_ms=42)
    assert click == jax_records.serialize_click(impression_id="abc#1", ts_ms=42)
    assert tuple(parse_click(click)) == tuple(jax_records.parse_click(click)) == ("abc#1", 42)


@pytest.mark.parametrize("rate", [0.01, 0.25, 0.5, 1.0])
def test_impression_sampled_takes_jax_decision_on_10000_ids(rate):
    ids = [f"trace-{i}" for i in range(10_000)]
    got = [impression_sampled(i, rate) for i in ids]
    assert got == [jax_sampled(i, rate) for i in ids]
    if rate < 1.0:
        assert abs(sum(got) / len(got) - rate) < 0.03
    from deepfm_tpu.fleet.split import split_point as jax_split_point
    assert [split_point(i, "x") for i in ids[:500]] == [jax_split_point(i, "x")
                                                        for i in ids[:500]]


# ------------------------------------------------------------- JoinService


def _case_click_in_window(logs):
    logs.imps(["a#0", "b#0"], at=0)
    logs.clicks(["a#0"], at=5)
    return {}, {"drain_at_eof": True}, {"positive_total": 1, "negative_total": 1,
                                        "emitted_total": 2}


def _case_out_of_order(logs):
    logs.clicks(["a#0"], at=0)
    logs.imps(["a#0"], at=3)
    return {}, {"drain_at_eof": True}, {"positive_total": 1, "negative_total": 0,
                                        "early_clicks": 0}


def _case_late_click_flips(logs):
    logs.imps(["a#0"], at=0)
    logs.clicks(["zz#0"], at=15)
    logs.clicks(["a#0"], at=16)
    return {}, {}, {"negative_total": 1, "flip_total": 1, "positive_total": 0,
                    "emitted_total": 1}


def _case_orphan_click(logs):
    logs.clicks(["ghost#0"], at=-5)
    logs.imps(["a#0"], at=0)
    return {}, {"drain_at_eof": True}, {"orphan_click_total": 1, "emitted_total": 1}


def _case_duplicate(logs):
    logs.imps(["a#0"], at=0)
    logs.imps(["a#0"], at=1)
    return {}, {"drain_at_eof": True}, {"duplicate_total": 1, "emitted_total": 1}


def _case_sampled_out(logs):
    kept, dropped = _ids_at(0.5, True, 1)[0], _ids_at(0.5, False, 1)[0]
    logs.imps([f"{kept}#0", f"{dropped}#0"], at=0)
    logs.clicks([f"{dropped}#0"], at=2)
    return {"sample_rate": 0.5}, {"drain_at_eof": True}, {
        "sampled_out_total": 2, "orphan_click_total": 0, "emitted_total": 1}


def _case_watermark(logs):
    logs.imps(["a#0"], at=0)
    logs.clicks(["a#0"], at=7)
    return {}, {}, {"positive_total": 1}


CASES = [_case_click_in_window, _case_out_of_order, _case_late_click_flips,
         _case_orphan_click, _case_duplicate, _case_sampled_out, _case_watermark]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[6:])
def test_join_output_and_state_are_byte_equal_to_jax(case, tmp_path):
    logs = _Logs(tmp_path)
    kw, run_kw, want = case(logs)
    port, jax, out_p, out_j = _both(logs, tmp_path, "out", run_kw, **kw)
    stats = _same_stats(port, jax)
    assert {k: stats[k] for k in want} == want
    a, b = _read_segments(out_p), _read_segments(out_j)
    assert a and a == b
    assert load_state(str(out_p)) == json.loads(b[STATE_NAME])


def test_watermark_is_click_segment_publish_time(tmp_path):
    logs = _Logs(tmp_path)
    _case_watermark(logs)
    port, _, out_p, _ = _both(logs, tmp_path, "out", {})
    assert port.stats()["watermark"] == pytest.approx(T0 + 7, abs=1.0)
    status = load_status(str(out_p))
    assert status["lag_seconds"] >= 0 and status["counters"]["positive"] == 1


def test_checkpoint_resumes_cursors_like_jax(tmp_path):
    logs = _Logs(tmp_path)
    logs.imps(["a#0", "b#0"], at=0)
    logs.clicks(["a#0"], at=5)
    _both(logs, tmp_path, "out", {})
    state = load_state(str(tmp_path / "out_port"))
    assert state["imp_cursor"][0] == state["click_cursor"][0] == segment_name(0)
    logs.clicks(["b#0"], at=8)
    port, jax, out_p, out_j = _both(logs, tmp_path, "out", {})
    assert port.run() == 0  # nothing new after the resume's pass
    stats = _same_stats(port, jax)
    assert stats["positive_total"] == 2 and stats["emitted_total"] == 2
    assert _read_segments(out_p) == _read_segments(out_j)


# ----------------------------------------------- crash-resume exactly once


def _flywheel_corpus(tmp_path):
    """Interleaved segments that cross several output rolls and
    checkpoints: 4 impression segments of 3 rows, clicks for every third,
    a late flip, an orphan, a duplicate."""
    logs = _Logs(tmp_path)
    pids = [f"u{i}#0" for i in range(12)]
    for seg in range(4):
        logs.imps(pids[seg * 3:(seg + 1) * 3], at=seg * 4, seed=seg * 7)
    logs.imps([pids[1]], at=17)
    logs.clicks([pids[0], pids[3]], at=6)
    logs.clicks([pids[6], "ghost#0"], at=14)
    logs.clicks([pids[9], pids[1]], at=26)
    return logs


def _run_join(cls, logs, out, *, crash=None):
    """One join run to its end; ``crash=(hook, nth)`` raises from the named
    hook at its nth call, then a fresh service resumes from the committed
    checkpoint and finishes."""
    def make():
        return cls(logs.imp, logs.click, str(out), attribution_window_secs=10.0,
                   roll_bytes=220, checkpoint_every_segments=2)

    svc = make()
    if crash is not None:
        kind, nth = crash
        count = [0]

        def boom(_):
            count[0] += 1
            if count[0] == nth:
                raise RuntimeError("injected join crash")

        setattr(svc, kind, boom)
    try:
        svc.run(drain_at_eof=True)
        return svc
    except RuntimeError:
        pass  # the injected kill: whatever was not checkpointed is lost
    resumed = make()
    resumed.run(drain_at_eof=True)
    return resumed


@pytest.mark.parametrize("crash", [
    ("on_segment", 1),  # the first output publish, before any checkpoint
    ("on_segment", 2),  # between checkpoints
    ("on_segment", 3),  # inside checkpoint()'s flush -> commit window
    ("on_checkpoint", 1),
    ("on_checkpoint", 2),
    ("on_checkpoint", 3),
], ids=lambda c: f"{c[0]}-{c[1]}")
def test_output_after_a_kill_and_resume_is_byte_equal_to_jax(tmp_path, crash):
    logs = _flywheel_corpus(tmp_path)
    jax = _run_join(JaxJoinService, logs, tmp_path / "jax")
    port = _run_join(JoinService, logs, tmp_path / "port", crash=crash)
    a, b = _read_segments(tmp_path / "port"), _read_segments(tmp_path / "jax")
    assert len(a) >= 3 and a == b, f"crash at {crash}: {sorted(a)} vs {sorted(b)}"
    assert _same_stats(port, jax)["emitted_total"] == 12


def test_resume_without_crash_consumes_nothing_twice(tmp_path):
    logs = _flywheel_corpus(tmp_path)
    out = tmp_path / "out"
    svc = _run_join(JoinService, logs, out)
    before = _read_segments(out)
    again = JoinService(logs.imp, logs.click, str(out), attribution_window_secs=10.0,
                        roll_bytes=220, checkpoint_every_segments=2)
    assert again.run(drain_at_eof=True) == 0
    assert _read_segments(out) == before
    assert again.stats()["emitted_total"] == svc.stats()["emitted_total"]


def test_join_follow_consumes_segments_as_published_then_stops(tmp_path):
    logs = _Logs(tmp_path)
    logs.imps(["a#0"], at=0)
    svc = JoinService(logs.imp, logs.click, str(tmp_path / "out"),
                      attribution_window_secs=10.0)
    stop = threading.Event()
    done = {}
    t = threading.Thread(target=lambda: done.setdefault(
        "n", svc.run(follow=True, stop=stop, poll_interval_secs=0.02)))
    t.start()
    try:
        logs.clicks(["a#0"], at=2)
        deadline = time.monotonic() + 5
        while svc.stats()["positive_total"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.stats()["positive_total"] == 1
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive() and done["n"] >= 2


@pytest.fixture()
def store(tmp_path):
    from deepfm_tpu_torch.utils.dev_object_store import serve

    server, base = serve(str(tmp_path / "store_root"))
    try:
        yield f"{base}/bucket"
    finally:
        server.shutdown()
        server.server_close()


def test_segment_writer_on_a_url_root_equals_jax(store):
    """SegmentWriter on an object-store prefix: one PUT a segment, the
    same names and bytes as JAX's writer on another prefix, and the
    sequence continued after what the prefix holds."""
    from deepfm_tpu_torch.data.object_store import get_store

    records = [serialize_ctr_example(float(i % 2), [i] * FIELD, [0.5] * FIELD)
               for i in range(20)]
    port = SegmentWriter(f"{store}/p", roll_bytes=150, roll_age_secs=0)
    jax = JaxSegmentWriter(f"{store}/j", roll_bytes=150, roll_age_secs=0)
    assert [port.append(r) for r in records] == [jax.append(r) for r in records]
    assert port.flush() == jax.flush()
    a, b = _read_segments(f"{store}/p"), _read_segments(f"{store}/j")
    assert len(a) >= 2 and a == b
    assert [rec for name in sorted(a) for rec in read_records(
        get_store().open_read_resuming(f"{store}/p/{name}"))] == records
    assert SegmentWriter(f"{store}/p").next_seq == len(a)


def test_the_join_reads_and_writes_url_roots_as_jax_does(store):
    """The join with its impression and click logs, its output and its
    state file on an object store, and JAX's join over the same input
    prefixes: the same output segments byte for byte, the same counters
    and cursors; the state loads back from the store.  (A URL log's
    publish time is when the tail first listed a segment, in both.)"""
    imps, clicks = _ids_at(1.0, True, 12, "u"), []
    for seq in range(3):
        pids = [f"{p}#0" for p in imps[4 * seq:4 * seq + 4]]
        publish_segment(f"{store}/imps", segment_name(seq),
                        b"".join(frame_record(_imp_record(p, seed=seq * 4 + i))
                                 for i, p in enumerate(pids)))
        clicks += pids[::2]
    publish_segment(f"{store}/clicks", segment_name(0), b"".join(
        frame_record(serialize_click(impression_id=p, ts_ms=int(T0 * 1000))) for p in clicks))
    assert load_state(f"{store}/out_port") is None
    kw = dict(attribution_window_secs=600.0)
    port = JoinService(f"{store}/imps", f"{store}/clicks", f"{store}/out_port", **kw)
    jax = JaxJoinService(f"{store}/imps", f"{store}/clicks", f"{store}/out_jax", **kw)
    assert port.run(drain_at_eof=True) == jax.run(drain_at_eof=True) == 4
    stats, jstats = port.stats(), jax.stats()
    for k in ("lag_seconds", "watermark"):  # the tails' listing times
        stats.pop(k), jstats.pop(k)
    assert stats == jstats
    assert (stats["positive_total"], stats["negative_total"]) == (6, 6)
    a, b = _read_segments(f"{store}/out_port"), _read_segments(f"{store}/out_jax")
    assert a and a == b
    state = load_state(f"{store}/out_port")
    from deepfm_tpu.flywheel.join import load_state as jax_load_state

    jstate = jax_load_state(f"{store}/out_jax")
    for k in ("imp_cursor", "click_cursor", "pending", "next_out_seq", "counters"):
        assert state[k] == jstate[k], k
    assert load_status(f"{store}/out_port")["counters"]["emitted"] == 12


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("field,value,match", [
    ("sample_rate", 0.0, "sample_rate"),
    ("sample_rate", 1.5, "sample_rate"),
    ("attribution_window_secs", 0.0, "attribution_window_secs"),
    ("segment_roll_bytes", 0, "segment_roll_bytes"),
    ("segment_roll_age_secs", 0.0, "segment_roll_age_secs"),
    ("join_checkpoint_every_segments", 0, "join_checkpoint"),
    ("queue_depth", 0, "queue_depth"),
])
def test_flywheel_field_validation_like_jax(field, value, match):
    with pytest.raises(ValueError, match=match):
        JaxFlywheelConfig(**{field: value})
    with pytest.raises(ValueError, match=match):
        FlywheelConfig(**{field: value})


def test_flywheel_cross_checks_and_keep_window_like_jax():
    assert FlywheelConfig() == FlywheelConfig(**JaxFlywheelConfig().__dict__)
    with pytest.raises(ValueError, match="impression_log_url"):
        FlywheelConfig(enabled=True)
    for d in ({"run": {"task_type": "feedback-train"}},
              {"run": {"task_type": "feedback_train"}}):
        with pytest.raises(ValueError, match="join_output_url"):
            JaxConfig.from_dict(d)
        with pytest.raises(ValueError, match="join_output_url"):
            Config.from_dict(d)
    d = {"run": {"task_type": "feedback-train"}, "flywheel": {"join_output_url": "/tmp/j"},
         "regions": {"publish_keep_window": 5}}
    cfg = Config.from_dict(d)
    assert cfg.flywheel.join_output_url == "/tmp/j" and cfg.regions.publish_keep_window == 5
    assert Config.from_dict(JaxConfig.from_dict(d).to_dict()) == cfg
    with pytest.raises(ValueError, match="publish_keep_window"):
        RegionsConfig(publish_keep_window=-1)
    # the CLI's flags and --set pairs resolve in one pass
    from deepfm_tpu_torch.launch.cli import resolve_config

    cfg, _ = resolve_config(["--task_type", "feedback-train",
                             "--set", "flywheel.join_output_url=/tmp/joined"])
    assert cfg.flywheel.join_output_url == "/tmp/joined"


# ---------------------------------------------------------- feedback-train


def test_feedback_train_routes_the_joined_stream_into_the_online_trainer(tmp_path,
                                                                         monkeypatch):
    from deepfm_tpu_torch.online import trainer as online_trainer
    from deepfm_tpu_torch.train.loop import run_task

    seen = {}
    monkeypatch.setattr(online_trainer, "run_online_train",
                        lambda cfg, device=None: seen.setdefault("cfg", (cfg, device)))
    cfg = Config.from_dict({"run": {"task_type": "feedback-train",
                                    "model_dir": str(tmp_path / "model")},
                            "flywheel": {"join_output_url": str(tmp_path / "joined")}})
    run_task(cfg, device="cpu")
    got, device = seen["cfg"]
    assert got.run.task_type == "online-train" and device == "cpu"
    assert got.data.training_data_dir == str(tmp_path / "joined")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_join_cli_then_feedback_train_end_to_end(tmp_path):
    """``python -m deepfm_tpu_torch.flywheel.join --drain`` (byte-equal to
    JAX's module main on the same logs), then ``--task_type feedback-train
    --device cpu`` on its output: every joined record trained, a version
    published; the same command again resumes and applies nothing."""
    logs = _Logs(tmp_path)
    pids = [f"p{i}#0" for i in range(10)]
    logs.imps(pids[:5], at=0)
    logs.imps(pids[5:], at=1, seed=5)
    logs.clicks(pids[::3], at=2)
    flags = ["--impressions", logs.imp, "--clicks", logs.click, "--window", "10", "--drain"]
    out = subprocess.run([sys.executable, "-m", "deepfm_tpu_torch.flywheel.join",
                          "--out", str(tmp_path / "joined"), *flags],
                         cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout)
    assert stats["positive_total"] == 4 and stats["emitted_total"] == 10
    assert jax_join_main(["--out", str(tmp_path / "joined_jax"), *flags]) == 0
    assert _read_segments(tmp_path / "joined") == _read_segments(tmp_path / "joined_jax")
    argv = [sys.executable, "-m", "deepfm_tpu_torch", "--task_type", "feedback-train",
            "--device", "cpu", "--model_dir", str(tmp_path / "ckpt"),
            "--servable_model_dir", str(tmp_path / "pub"), "--feature_size", "50",
            "--field_size", str(FIELD), "--embedding_size", "4", "--deep_layers", "8",
            "--dropout", "1.0", "--batch_size", "4",
            "--set", "run.online_idle_timeout_secs=0.3",
            "--set", "run.online_publish_every_steps=2",
            "--set", f"flywheel.join_output_url={tmp_path / 'joined'}"]
    lines = []
    for _ in range(2):
        out = subprocess.run(argv, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        lines.append([json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")])
    done = [r for r in lines[0] if r["kind"] == "online_done"][0]
    assert done["applied"] == 3 and done["examples"] == 10  # ceil(10 / 4) batches
    assert [r["version"] for r in lines[0] if r["kind"] == "publish"] == [1, 2]
    assert [r["kind"] for r in lines[1]] == ["online_resume", "online_done"]
    assert lines[1][-1]["applied"] == 0 and lines[1][0]["step"] == 3


def test_join_module_main_refuses_missing_roots(tmp_path):
    with pytest.raises(SystemExit):
        join_main(["--out", str(tmp_path)])
