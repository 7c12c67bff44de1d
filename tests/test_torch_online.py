"""The port's online training (deepfm_tpu_torch/online/stream.py,
trainer.py, the publisher's keep_window, the online commit in
checkpoint/ckpt.py, convert.online_payload_from_jax) on the CPU at a small
width (V = 64, F = 5, K = 4, MLP (8,), batch 8), mirroring
tests/test_online.py: the stream's cursors, spans, partial flush, follow
and idle timeout; the trainer against its one-pass replay (exactly,
also across a crash after a commit, a torn step and a stop that flushes a
partial batch, through the CLI and a real SIGTERM); and held against the
JAX package on the same files: (a) both readers give identical batches
and cursors, (b) a JAX online commit converted into the port resumes
there, and the port's finished run matches JAX's uninterrupted trainer
within 1e-5 (float32, dropout keep 1.0, lr 5e-4), its manifests' version,
step, cursor and watermark equal to JAX's."""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.checkpoint import make_checkpointer as jax_make_checkpointer
from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.online import DirectoryTail as JaxDirectoryTail
from deepfm_tpu.online import EventLogReader as JaxEventLogReader
from deepfm_tpu.online import ModelPublisher as JaxPublisher
from deepfm_tpu.online import OnlineTrainer as JaxOnlineTrainer
from deepfm_tpu.online import StreamCursor as JaxCursor
from deepfm_tpu.online.trainer import OnlinePayload as JaxPayload
from deepfm_tpu.online.trainer import restore_latest_payload as jax_restore_latest
from deepfm_tpu.train.step import create_train_state as jax_create_train_state
from deepfm_tpu_torch.checkpoint import Checkpointer, make_checkpointer
from deepfm_tpu_torch.convert import online_payload_from_jax, train_state_from_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.online import (DirectoryTail, EventLogReader, ModelPublisher,
                                     OnlineTrainer, StreamCursor, append_segment,
                                     latest_manifest, list_versions, param_tree_hash,
                                     read_manifest, segment_name)
from deepfm_tpu_torch.online.stream import open_tail, publish_segment
from deepfm_tpu_torch.online.trainer import (OnlinePayload, commit_payload,
                                             cursor_from_arrays, cursor_to_arrays,
                                             replay_to_state, restore_latest_payload)
from deepfm_tpu_torch.train.step import create_train_state

ROOT = Path(__file__).resolve().parent.parent
FEATURE, FIELD = 64, 5
MODEL = {"feature_size": FEATURE, "field_size": FIELD, "embedding_size": 4,
         "deep_layers": (8,), "dropout_keep": (1.0,), "compute_dtype": "float32",
         "fused_kernel": "off"}


def _events(n, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random(n) < 0.3).astype(np.float32),
            rng.integers(0, FEATURE, (n, FIELD)).astype(np.int64),
            rng.random((n, FIELD)).astype(np.float32))


def _fill_stream(root, *, segments, rows=8, seq0=0):
    for seq in range(seq0, seq0 + segments):
        append_segment(root, *_events(rows, seed=seq), seq=seq)


def _cfg_dict(root, lr=0.01, dropout=1.0, **run_overrides):
    run = {"model_dir": os.path.join(root, "ckpt"),
           "servable_model_dir": os.path.join(root, "publish"),
           "checkpoint_every_steps": 2, "online_publish_every_steps": 2,
           "log_steps": 10_000}
    run.update(run_overrides)
    return {"model": {**MODEL, "dropout_keep": (dropout,)},
            "optimizer": {"learning_rate": lr},
            "data": {"training_data_dir": os.path.join(root, "stream"), "batch_size": 8},
            "run": run}


def _cfg(root, **kw) -> Config:
    return Config.from_dict(_cfg_dict(str(root), **kw))


def _tensors(state) -> dict:
    out = dict(state.model.state_dict())
    for name, slots in state.optimizer.slots.items():
        out.update({f"{name}.{s}": t for s, t in slots.items()})
    return out


def _assert_bit_equal(a, b):
    assert a.step == b.step
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


# ---------------------------------------------------------------- stream


def test_segment_names_sort_numerically():
    names = [segment_name(i) for i in (0, 1, 9, 10, 11, 100)]
    assert names == sorted(names)


def test_reader_batches_and_cursor_resume(tmp_path):
    stream = str(tmp_path / "stream")
    _fill_stream(stream, segments=3)
    reader = EventLogReader(DirectoryTail(stream), field_size=FIELD, batch_size=8)
    items = list(reader.batches())
    assert len(items) == 3
    batch, cursor = items[0]
    assert batch["feat_ids"].shape == (8, FIELD) and batch["label"].shape == (8,)
    assert cursor == StreamCursor(segment=segment_name(0), record=8)
    rest = list(reader.batches(cursor))
    assert len(rest) == 2
    np.testing.assert_array_equal(rest[0][0]["feat_ids"], items[1][0]["feat_ids"])
    assert reader.watermark() == pytest.approx(
        os.path.getmtime(os.path.join(stream, segment_name(2))), abs=1.0)


def test_reader_batches_span_segments_and_flush_partial(tmp_path):
    stream = str(tmp_path / "stream")
    _fill_stream(stream, segments=3, rows=5)  # 15 rows, batch 6 -> 6 + 6 + 3
    reader = EventLogReader(DirectoryTail(stream), field_size=FIELD, batch_size=6)
    items = list(reader.batches())
    assert [it[0]["label"].shape[0] for it in items] == [6, 6, 3]
    assert items[0][1] == StreamCursor(segment=segment_name(1), record=1)
    rest = list(reader.batches(items[0][1]))
    np.testing.assert_array_equal(rest[0][0]["feat_vals"], items[1][0]["feat_vals"])


def test_reader_follow_picks_up_new_segments(tmp_path):
    stream = str(tmp_path / "stream")
    _fill_stream(stream, segments=1)
    reader = EventLogReader(DirectoryTail(stream), field_size=FIELD, batch_size=8,
                            poll_interval_secs=0.02)
    stop = threading.Event()
    got = []
    t = threading.Thread(target=lambda: got.extend(reader.batches(follow=True, stop=stop)),
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 10
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(got) == 1
        labels, ids, vals = _events(8, seed=7)
        append_segment(stream, labels, ids, vals, seq=1)
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(got) == 2, "follow mode never saw the late segment"
        np.testing.assert_array_equal(got[1][0]["feat_ids"], ids)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()


def test_reader_idle_timeout_returns_and_flushes_the_partial_batch(tmp_path):
    stream = str(tmp_path / "stream")
    _fill_stream(stream, segments=1, rows=12)
    reader = EventLogReader(DirectoryTail(stream), field_size=FIELD, batch_size=8,
                            poll_interval_secs=0.02)
    t0 = time.monotonic()
    items = list(reader.batches(follow=True, idle_timeout_secs=0.2))
    assert [it[0]["label"].shape[0] for it in items] == [8, 4]
    assert items[-1][1] == StreamCursor(segment_name(0), 12)
    assert time.monotonic() - t0 < 5


def test_reader_matches_jax_on_the_same_files(tmp_path):
    """(a) The same batches, cursors and watermark as JAX's reader: whole,
    from a mid-segment cursor, and in follow mode to the idle timeout."""
    stream = str(tmp_path / "stream")
    _fill_stream(stream, segments=4, rows=5)
    port = EventLogReader(DirectoryTail(stream), field_size=FIELD, batch_size=6,
                          poll_interval_secs=0.02)
    ref = JaxEventLogReader(JaxDirectoryTail(stream), field_size=FIELD, batch_size=6,
                            poll_interval_secs=0.02)
    for start in (StreamCursor(), StreamCursor(segment_name(1), 3)):
        for follow in (False, True):
            kw = {"follow": follow, "idle_timeout_secs": 0.1}
            got = list(port.batches(start, **kw))
            want = list(ref.batches(JaxCursor(*start), **kw))
            assert len(got) == len(want) >= 2
            for (gb, gc), (wb, wc) in zip(got, want):
                assert tuple(gc) == tuple(wc) and gb.keys() == wb.keys()
                for k in gb:
                    assert gb[k].dtype == wb[k].dtype
                    np.testing.assert_array_equal(gb[k], wb[k])
    assert port.watermark() == ref.watermark() > 0
    assert port.stats() == ref.stats()


def test_url_roots_raise(tmp_path):
    """Object-store roots of the online path (the port's dev store): the
    URL tail lists and reads what ``publish_segment`` PUT, and the online
    trainer over a URL event log, model_dir and publish root equals the
    one over local directories, manifest for manifest."""
    from deepfm_tpu_torch.utils.dev_object_store import serve

    server, base = serve(str(tmp_path / "store"), max_keys=2)
    try:
        events = f"{base}/bucket/events"
        local = str(tmp_path / "local")
        for seq in range(5):
            labels, ids, vals = _events(8, seed=seq)
            append_segment(events, labels, ids, vals, seq=seq)
            append_segment(os.path.join(local, "stream"), labels, ids, vals, seq=seq)
        tail = open_tail(events)
        assert tail.list_segments() == [segment_name(s) for s in range(5)]
        with tail.open_segment(segment_name(2)) as f:
            assert f.read() == open(os.path.join(local, "stream", segment_name(2)), "rb").read()
        assert tail.segment_time(segment_name(2)) > 0
        cfg = _cfg(local)
        url_cfg = cfg.with_overrides(
            data={"training_data_dir": events},
            run={"model_dir": f"{base}/bucket/ckpt",
                 "servable_model_dir": f"{base}/bucket/publish"})
        got = OnlineTrainer(url_cfg, device="cpu").run(follow=False)
        want = OnlineTrainer(cfg, device="cpu").run(follow=False)
        _assert_bit_equal(got, want)
        pub = url_cfg.run.servable_model_dir
        assert list_versions(pub) == list_versions(cfg.run.servable_model_dir) == [1, 2, 3]
        for v in (1, 2, 3):
            a, b = read_manifest(pub, v), read_manifest(cfg.run.servable_model_dir, v)
            assert (a.step, a.param_hash, a.cursor) == (b.step, b.param_hash, b.cursor)
        # a rerun resumes from the URL model_dir's commit and applies nothing
        again = OnlineTrainer(url_cfg, device="cpu").run(follow=False)
        _assert_bit_equal(again, want)
    finally:
        server.shutdown()
        server.server_close()


def test_cursor_array_roundtrip():
    for c in (StreamCursor(segment=segment_name(42), record=17), StreamCursor()):
        seg, length, record = cursor_to_arrays(c)
        assert seg.shape == (256,) and seg.dtype == np.uint8
        assert cursor_from_arrays(seg, length, record) == c
    with pytest.raises(ValueError, match="256 bytes"):
        cursor_to_arrays(StreamCursor("x" * 257, 0))


# ---------------------------------------------------------------- publisher


def test_keep_window_widens_retention_like_jax(tmp_path):
    cfg = _cfg(tmp_path)
    sd = create_train_state(cfg, "cpu").model.state_dict()
    jax_state = jax_create_train_state(JaxConfig.from_dict(_cfg_dict(str(tmp_path))))
    ref = JaxPublisher(str(tmp_path / "jax"), keep=2, keep_window=4)
    for _ in range(6):
        ref.publish(JaxConfig.from_dict(_cfg_dict(str(tmp_path))), jax_state)
    for keep, window, kept in ((2, 0, [5, 6]), (2, 4, list_versions(ref.root)),
                               (3, 1, [4, 5, 6])):
        port = ModelPublisher(str(tmp_path / f"p{keep}{window}"), keep=keep, keep_window=window)
        for _ in range(6):
            port.publish(cfg, sd)
        assert list_versions(port.root) == kept
        assert sorted(os.listdir(os.path.join(port.root, "versions"))) == [
            f"{v:08d}" for v in kept]
    assert list_versions(ref.root) == [3, 4, 5, 6]
    with pytest.raises(ValueError, match="keep_window"):
        ModelPublisher(str(tmp_path / "bad"), keep_window=-1)
    # the trainer's publisher honours regions.publish_keep_window
    cfg = _cfg(tmp_path, keep_checkpoints=1, online_publish_every_steps=1).with_overrides(
        regions={"publish_keep_window": 3})
    _fill_stream(cfg.data.training_data_dir, segments=5)
    OnlineTrainer(cfg, device="cpu").run(follow=False)
    assert list_versions(cfg.run.servable_model_dir) == [3, 4, 5]


# ---------------------------------------------------------------- trainer


def test_online_trainer_matches_offline_replay(tmp_path):
    cfg = _cfg(tmp_path)
    _fill_stream(cfg.data.training_data_dir, segments=3)
    state = OnlineTrainer(cfg, device="cpu").run(follow=False)
    assert state.step == 3
    _assert_bit_equal(state, replay_to_state(cfg, device="cpu"))
    manifest = latest_manifest(cfg.run.servable_model_dir)
    assert manifest.step == 3 and list_versions(cfg.run.servable_model_dir) == [1, 2]
    assert manifest.cursor == {"segment": segment_name(2), "record": 8}
    from deepfm_tpu_torch.convert import params_to_jax

    assert manifest.param_hash == param_tree_hash(*params_to_jax(state.model.state_dict(),
                                                                 cfg.model))
    # the commit holds the cursor beside the state; a plain restore reads it too
    payload = Checkpointer(cfg.run.model_dir).restore(
        OnlinePayload.wrap(create_train_state(cfg, "cpu"), StreamCursor()))
    assert payload.cursor() == StreamCursor(segment_name(2), 8) and payload.step == 3
    assert int(payload.fence_token) == 0
    _assert_bit_equal(payload.train, state)
    _assert_bit_equal(Checkpointer(cfg.run.model_dir).restore(
        create_train_state(cfg, "cpu")), state)


class _CrashAfterCommit(RuntimeError):
    pass


def test_crash_between_cursor_commit_and_publish_resumes_exactly_once(tmp_path):
    cfg = _cfg(tmp_path, dropout=0.5)
    _fill_stream(cfg.data.training_data_dir, segments=6)
    calls = []

    def crash(state, cursor):
        calls.append((state.step, cursor))
        raise _CrashAfterCommit(f"killed after commit at step {state.step}")

    with pytest.raises(_CrashAfterCommit):
        OnlineTrainer(cfg, device="cpu").run(follow=False, on_commit=crash)
    assert calls == [(2, StreamCursor(segment=segment_name(1), record=8))]
    assert latest_manifest(cfg.run.servable_model_dir) is None
    state = OnlineTrainer(cfg, device="cpu").run(follow=False)
    assert state.step == 6
    _assert_bit_equal(state, replay_to_state(cfg, device="cpu"))
    manifest = latest_manifest(cfg.run.servable_model_dir)
    assert manifest.step == 6 and manifest.cursor == {"segment": segment_name(5), "record": 8}


def test_kill_during_commit_is_unreadable_and_resume_takes_the_previous_payload(tmp_path):
    cfg = _cfg(tmp_path, online_publish_every_steps=0)
    _fill_stream(cfg.data.training_data_dir, segments=6)
    OnlineTrainer(cfg, device="cpu").run(follow=False, max_batches=4)
    ckpt_dir = os.path.abspath(cfg.run.model_dir)
    assert Checkpointer(ckpt_dir).all_steps() == [2, 4]
    # a kill during the write leaves the temporary directory: never listed
    torn = Path(ckpt_dir) / ".tmp-5-1234567"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"\x00" * 64)
    ck = Checkpointer(ckpt_dir)
    assert ck.latest_step() == 4
    restored = ck.restore(OnlinePayload.wrap(create_train_state(cfg, "cpu"), StreamCursor()))
    assert restored.cursor() == StreamCursor(segment_name(3), 8)
    # a step renamed into place but torn: resume falls back to step 4
    shutil.copytree(os.path.join(ckpt_dir, "4"), os.path.join(ckpt_dir, "5"))
    with open(os.path.join(ckpt_dir, "5", "state.pt"), "r+b") as f:
        f.truncate(100)
    state = OnlineTrainer(cfg, device="cpu").run(follow=False)
    assert state.step == 6 and 6 in Checkpointer(ckpt_dir).all_steps()
    _assert_bit_equal(state, replay_to_state(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="unreadable"):
        restore_latest_payload(_Only(ck, 5), OnlinePayload.wrap(
            create_train_state(cfg, "cpu"), StreamCursor()))


class _Only:
    """A checkpointer that lists one step of another."""

    def __init__(self, ck, step):
        self.ck, self.step = ck, step

    def all_steps(self):
        return [self.step]

    def restore(self, target, step):
        return self.ck.restore(target, step)


def test_a_commit_that_did_not_land_raises(tmp_path):
    state = create_train_state(_cfg(tmp_path), "cpu")

    class _SilentlyFailing:
        def save(self, payload, *, block=False):
            assert block
            return True

        def all_steps(self):
            return []

    with pytest.raises(RuntimeError, match="did not become durable"):
        commit_payload(_SilentlyFailing(), state, StreamCursor())


def test_online_and_train_checkpoints_keep_their_formats(tmp_path):
    cfg = _cfg(tmp_path)
    state = create_train_state(cfg, "cpu")
    state.step = 3
    ck = make_checkpointer(tmp_path / "plain")
    ck.save(state, block=True)
    raw = torch.load(tmp_path / "plain" / "3" / "state.pt", weights_only=True)
    assert "online" not in raw
    with pytest.raises(ValueError, match="not an online commit"):
        ck.restore(OnlinePayload.wrap(create_train_state(cfg, "cpu"), StreamCursor()))
    ck = make_checkpointer(tmp_path / "online")
    commit_payload(ck, state, StreamCursor(segment_name(9), 5))
    raw = torch.load(tmp_path / "online" / "3" / "state.pt", weights_only=True)
    assert set(raw["online"]) == {"cursor_segment", "cursor_len", "cursor_record",
                                  "fence_token"}
    fresh = create_train_state(cfg, "cpu")
    assert ck.restore(fresh).step == 3  # a train restore reads an online commit
    _assert_bit_equal(fresh, state)


def test_online_trainer_rejects_two_tower_missing_roots_and_world_size(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="two-tower"):
        OnlineTrainer(_cfg(tmp_path).with_overrides(model={"model_name": "two_tower"}),
                      device="cpu")
    with pytest.raises(ValueError, match="training_data_dir"):
        OnlineTrainer(_cfg(tmp_path).with_overrides(data={"training_data_dir": ""}),
                      device="cpu")
    with pytest.raises(ValueError, match="servable_model_dir"):
        OnlineTrainer(_cfg(tmp_path).with_overrides(run={"servable_model_dir": ""}),
                      device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="single-process"):
        OnlineTrainer(_cfg(tmp_path), device="cpu")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_sigterm_flushes_the_partial_batch_and_the_resume_equals_one_cut_pass(tmp_path):
    """``python -m deepfm_tpu_torch --task_type online-train --device cpu``
    following a log of 2 segments of 5 rows (batch 8): a real SIGTERM after
    its first publish stops it with the 2 buffered records trained as a
    short batch, a commit and a publish, exit 0 and ``online_done``; the
    same command, after 2 more segments, logs ``online_resume`` at that
    cursor and ends bit-equal to one pass cut there (dropout 0.5: the
    dropout generator rides in the commit)."""
    cfg_doc = _cfg_dict(str(tmp_path), dropout=0.5, online_publish_every_steps=1,
                        online_idle_timeout_secs=60.0)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg_doc))
    stream = cfg_doc["data"]["training_data_dir"]
    _fill_stream(stream, segments=2, rows=5)
    argv = [sys.executable, "-m", "deepfm_tpu_torch", "--task_type", "online-train",
            "--device", "cpu", "--config", str(tmp_path / "cfg.json")]
    proc = subprocess.Popen(argv, cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(json.loads(line))
            if lines[-1]["kind"] == "publish":
                time.sleep(0.3)  # the trainer waits for more with 2 records buffered
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    lines += [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    done = [r for r in lines if r["kind"] == "online_done"]
    assert len(done) == 1 and (done[0]["applied"], done[0]["examples"]) == (2, 10)
    cut = StreamCursor(segment_name(1), 5)
    assert (done[0]["segment"], done[0]["record"]) == tuple(cut)
    assert [r["step"] for r in lines if r["kind"] == "publish"] == [1, 2]
    _fill_stream(stream, segments=2, rows=5, seq0=2)
    cfg_doc["run"]["online_idle_timeout_secs"] = 0.3
    (tmp_path / "cfg.json").write_text(json.dumps(cfg_doc))
    out = subprocess.run(argv, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert lines[0] == {"kind": "online_resume", "step": 2, "segment": cut.segment,
                        "record": cut.record}
    cfg = Config.from_dict(cfg_doc)
    final = Checkpointer(cfg.run.model_dir).restore(
        OnlinePayload.wrap(create_train_state(cfg, "cpu"), StreamCursor()))
    assert final.cursor() == StreamCursor(segment_name(3), 5) and final.step == 4
    _assert_bit_equal(final.train, replay_to_state(cfg, cuts=[cut], device="cpu"))
    # the plain replay cuts its batches elsewhere: a resume is not held to it
    assert replay_to_state(cfg, device="cpu").step == 3


# ----------------------------------------------- a JAX commit resumed here


def _jax_state_as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_a_jax_online_commit_resumes_in_the_port_and_matches_jax(tmp_path):
    """(b) JAX's trainer commits after 4 batches; its payload goes through
    ``online_payload_from_jax`` into a port commit; the port's trainer
    resumes it and finishes the log, publishing into the same root.  Its
    params and Adam moments match JAX's uninterrupted trainer within 1e-5,
    and every manifest's version, step, cursor and watermark equal JAX's."""
    stream = str(tmp_path / "stream")
    _fill_stream(stream, segments=8)

    def doc(name):
        d = _cfg_dict(str(tmp_path), lr=5e-4, keep_checkpoints=10,
                      model_dir=str(tmp_path / name / "ckpt"),
                      servable_model_dir=str(tmp_path / name / "publish"))
        d["data"]["training_data_dir"] = stream
        return d

    # JAX, uninterrupted
    whole = JaxOnlineTrainer(JaxConfig.from_dict(doc("whole"))).run(follow=False)
    # JAX for 4 batches, then the port from its commit
    jcfg = JaxConfig.from_dict(doc("split"))
    JaxOnlineTrainer(jcfg).run(follow=False, max_batches=4)
    ck = jax_make_checkpointer(jcfg.run.model_dir)
    payload = jax_restore_latest(ck, JaxPayload.wrap(jax_create_train_state(jcfg),
                                                     JaxCursor()))
    ck.close()
    cfg = Config.from_dict({**doc("split"), "run": {**doc("split")["run"],
                                                    "model_dir": str(tmp_path / "port")}})
    ported = online_payload_from_jax(_jax_state_as_numpy(payload), cfg, device="cpu")
    state, cursor = ported.train, ported.cursor()
    assert cursor == StreamCursor(segment_name(3), 8) and state.step == ported.step == 4
    assert int(ported.fence_token) == int(payload.fence_token)
    commit_payload(make_checkpointer(cfg.run.model_dir), state, cursor)
    got = OnlineTrainer(cfg, device="cpu").run(follow=False)
    assert got.step == int(whole.step) == 8
    want = train_state_from_jax(_jax_state_as_numpy(whole), cfg, device="cpu")
    tg, tw = _tensors(got), _tensors(want)
    assert tg.keys() == tw.keys()
    for k in tw:
        np.testing.assert_allclose(tg[k].numpy(), tw[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert got.optimizer.count == want.optimizer.count == 8
    split, ref = cfg.run.servable_model_dir, str(tmp_path / "whole" / "publish")
    assert list_versions(split) == list_versions(ref) == [1, 2, 3, 4]
    for v in (1, 2, 3, 4):
        a, b = read_manifest(split, v), read_manifest(ref, v)
        assert (a.version, a.step, a.cursor, a.watermark) == (b.version, b.step, b.cursor,
                                                              b.watermark)
        assert a.watermark > 0
