"""The publish task (deepfm_tpu_torch/elastic/mpmd.py) on the CPU.

Two gloo ranks train a [1, 2] elastic job with inline publishes
(tests/_torch_elastic_worker.py), committing row files.  The
``PayloadPublisher`` reads a commit on the host (row files joined, no
grid) and publishes the same ``param_hash`` as the trainer's inline
publish of that step; it deletes a version tree left without a
manifest at start; under the coordinator it publishes with its own
lease's token and stops on a stale one; and ``--task_type publish`` runs
it as a command that exits 0."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_elastic_worker import Harness, spawn_ranks
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.elastic import coord
from deepfm_tpu_torch.elastic.mpmd import PayloadPublisher, read_payload_tree
from deepfm_tpu_torch.online import append_segment, latest_manifest, list_versions
from deepfm_tpu_torch.online.publisher import read_manifest

ROOT = Path(__file__).resolve().parent.parent
FEATURE, FIELD = 61, 5  # 61 rows pad to 62 at model_parallel 2


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A [1, 2] elastic run over 4 batches: commits (row files) and inline
    publishes at steps 2 and 4."""
    root = tmp_path_factory.mktemp("mpmd")
    stream = str(root / "stream")
    for seq in range(4):
        rng = np.random.default_rng(seq)
        append_segment(stream, (rng.random(8) < 0.3).astype(np.float32),
                       rng.integers(0, FEATURE, (8, FIELD)).astype(np.int64),
                       rng.random((8, FIELD)).astype(np.float32), seq=seq)
    h = Harness([0, 1])
    doc = {"model": {"feature_size": FEATURE, "field_size": FIELD, "embedding_size": 4,
                     "deep_layers": [8], "dropout_keep": [1.0], "compute_dtype": "float32"},
           "optimizer": {"learning_rate": 0.01},
           "data": {"training_data_dir": stream, "batch_size": 8},
           "run": {"model_dir": str(root / "ckpt"), "servable_model_dir": str(root / "inline"),
                   "checkpoint_every_steps": 2, "online_publish_every_steps": 2,
                   "keep_checkpoints": 5, "log_steps": 10_000},
           "elastic": {"enabled": True, "prefer_model_parallel": 2,
                       "coordinator_url": h.coord_url, "heartbeat_interval_secs": 0.2,
                       "registry_debounce_polls": 1, "poll_interval_secs": 0.05}}
    try:
        results = spawn_ranks([{"cfg": doc, "device_id": i, "store": h.store_addr,
                                "out": str(root / f"rank-{i}.pt")} for i in (0, 1)])
        assert all(r["error"] is None for r in results), [r["error"] for r in results]
        yield {"root": root, "doc": doc, "harness": h}
    finally:
        h.close()


def _cfg(job, publish_root, **elastic) -> Config:
    doc = job["doc"]
    return Config.from_dict({**doc, "run": {**doc["run"], "servable_model_dir": publish_root},
                             "elastic": {**doc["elastic"], "coordinator_url": "", **elastic}})


def test_the_payload_publisher_publishes_the_inline_hash(job, tmp_path):
    step, tree = read_payload_tree(job["doc"]["run"]["model_dir"])
    assert step == 4 and tree["model"]["fm_w"].shape[0] == 62 and "rows" in tree
    pub = PayloadPublisher(_cfg(job, str(tmp_path / "pub")))
    assert pub.publish_once() == 4 and pub.publish_once() is None
    got = latest_manifest(str(tmp_path / "pub"))
    inline = job["doc"]["run"]["servable_model_dir"]
    want = next(read_manifest(inline, v) for v in list_versions(inline)
                if read_manifest(inline, v).step == 4)
    assert (got.step, got.param_hash, got.cursor, got.feature_size) == \
        (4, want.param_hash, want.cursor, FEATURE)
    assert got.extra["mpmd"]["payload_fence_token"] == \
        int(tree["online"]["fence_token"]) > 0
    assert pub.lag_s and pub.lag_s[-1][0] == 4
    assert pub.metrics_snapshot()["published"] == 1


def test_orphans_are_cleaned_and_a_stale_token_stops_it(job, tmp_path):
    pub_root = tmp_path / "pub"
    (pub_root / "versions" / "00000007").mkdir(parents=True)
    (pub_root / "versions" / "00000007" / "params.npz").write_bytes(b"torn")
    h = job["harness"]
    cfg = _cfg(job, str(pub_root), coordinator_url=h.coord_url)
    first = PayloadPublisher(cfg)
    assert first.run(max_publishes=1) == 1
    assert not (pub_root / "versions" / "00000007").exists()
    assert first.metrics_snapshot()["orphans_cleaned"] == 1
    token = latest_manifest(str(pub_root)).extra["fence_token"]
    assert coord.read_fence(str(pub_root)) == token > 0
    # a newer publisher incarnation owns another root: this lease's token
    # is refused there, and the loop stops
    other = tmp_path / "other"
    coord.write_fence(str(other), token + 100, holder="newer")
    late = PayloadPublisher(_cfg(job, str(other), coordinator_url=h.coord_url))
    assert late.run(idle_timeout_secs=5.0) == 0
    assert late.metrics_snapshot()["fence_refused"] >= 1  # the lease tick, then the publish
    assert list_versions(str(other)) == []


def test_the_publish_task_runs_as_a_command(job, tmp_path):
    doc = job["doc"]
    cmd = [sys.executable, "-m", "deepfm_tpu_torch", "--task_type", "publish", "--device",
           "cpu", "--model_dir", doc["run"]["model_dir"], "--servable_model_dir",
           str(tmp_path / "pub"), "--feature_size", str(FEATURE), "--field_size", str(FIELD),
           "--embedding_size", "4", "--deep_layers", "8",
           "--coordinator_url", job["harness"].coord_url,
           "--set", "run.online_idle_timeout_secs=0.5",
           "--set", "elastic.heartbeat_interval_secs=0.2"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert [r["kind"] for r in lines][-1] == "publisher_done"
    assert lines[-1]["published"] == 1
    assert latest_manifest(str(tmp_path / "pub")).step == 4
