"""The port's object-store model_dir (deepfm_tpu_torch/checkpoint/
remote.py), the cases of tests/test_remote_ckpt.py on the port's
checkpointer against the port's dev store: a transient PUT retried
within one save, an exhausted upload logged on the next save and
re-enqueued, the durability barriers raising, a step committed before its
retention failed not uploaded again, the re-enqueue dropping steps that
retention removed, staging leftovers without a marker purged at start,
retention deleting the marker first, and no marker for a failed upload.
A URL model_dir at a world size above 1 raises.  The train task over a
URL model_dir resumes bit for bit, every remote step with its marker."""

import logging
import os
import types

import pytest
import torch

from deepfm_tpu_torch.checkpoint.remote import _MARKER, RemoteCheckpointer
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.data.object_store import HttpObjectStore, ObjectStoreError
from deepfm_tpu_torch.train.step import create_train_state, train_step
from deepfm_tpu_torch.utils.dev_object_store import serve

CFG = Config.from_dict({
    "model": {"feature_size": 80, "field_size": 4, "embedding_size": 4, "deep_layers": (8,),
              "dropout_keep": (1.0,), "compute_dtype": "float32"},
    "optimizer": {"learning_rate": 0.01},
})


class FlakyStore(HttpObjectStore):
    """A store whose PUTs fail on demand."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.fail_puts = 0
        self.put_urls: list[str] = []

    def put(self, url, data):
        self.put_urls.append(url)
        if self.fail_puts > 0:
            self.fail_puts -= 1
            raise ObjectStoreError(f"injected transient failure for {url}")
        super().put(url, data)


@pytest.fixture()
def remote_env(tmp_path):
    root = tmp_path / "store_root"
    (root / "bucket").mkdir(parents=True)
    server, base = serve(str(root))
    yield f"{base}/bucket/model", FlakyStore(timeout=10), tmp_path
    server.shutdown()
    server.server_close()


def _ckptr(url, store, tmp_path, **kwargs):
    rc = RemoteCheckpointer(url, staging_dir=str(tmp_path / "staging"),
                            retry_backoff_secs=0.01, **kwargs)
    rc._store = store
    return rc


def _states(n):
    """``n`` states, the i-th trained i + 1 steps (each its own object)."""
    g = torch.Generator().manual_seed(0)
    batches = [{"feat_ids": torch.randint(0, 80, (8, 4), generator=g),
                "feat_vals": torch.rand((8, 4), generator=g),
                "label": (torch.rand(8, generator=g) < 0.3).float()} for _ in range(n)]
    out = []
    for i in range(n):
        state = create_train_state(CFG, "cpu")
        for b in batches[:i + 1]:
            train_step(state, b)
        out.append(state)
    return out


def test_transient_put_failure_retried_within_one_save(remote_env):
    url, store, tmp = remote_env
    rc = _ckptr(url, store, tmp, upload_retries=3)
    (s1,) = _states(1)
    store.fail_puts = 1
    assert rc.save(s1, block=True)
    assert rc._remote_steps() == [1] and not rc._failed_steps
    rc.close()


def test_exhausted_retries_logged_on_next_save_and_reenqueued(remote_env, caplog):
    url, store, tmp = remote_env
    rc = _ckptr(url, store, tmp, upload_retries=2)
    s1, s2 = _states(2)
    store.fail_puts = 10_000
    assert rc.save(s1)
    rc._uploader.join()
    assert rc._failed_steps == {1}
    store.fail_puts = 0
    with caplog.at_level(logging.WARNING):
        assert rc.save(s2, block=True)
    assert any("re-enqueued" in r.message for r in caplog.records)
    assert rc._remote_steps() == [1, 2] and not rc._failed_steps
    rc.close()


def test_block_save_and_close_still_raise(remote_env):
    url, store, tmp = remote_env
    rc = _ckptr(url, store, tmp, upload_retries=1)
    (s1,) = _states(1)
    store.fail_puts = 10_000
    with pytest.raises(ObjectStoreError, match="injected"):
        rc.save(s1, block=True)
    store.fail_puts = 0
    assert rc._failed_steps == {1}
    rc.close()


def test_committed_step_not_reuploaded_after_retention_failure(remote_env):
    url, store, tmp = remote_env
    rc = _ckptr(url, store, tmp, upload_retries=1, max_to_keep=2)
    s1, s2, s3, s4 = _states(4)
    assert rc.save(s1, block=True) and rc.save(s2, block=True)
    real_delete = HttpObjectStore.delete

    def failing_delete(self_store, u):
        raise ObjectStoreError(f"injected delete failure for {u}")

    store.delete = failing_delete.__get__(store)
    rc.save(s3)
    rc._uploader.join()
    assert 3 in rc._remote_steps() and rc._failed_steps == {3}
    store.delete = real_delete.__get__(store)
    store.put_urls = []
    rc.save(s4, block=True)
    assert not rc._failed_steps
    assert not any("/3/" in u or u.endswith(f"{_MARKER}3") for u in store.put_urls)
    assert any("/4/" in u for u in store.put_urls)
    assert rc._remote_steps() == [3, 4]
    rc.close()


def test_reenqueue_skips_steps_dropped_by_retention(remote_env):
    url, store, tmp = remote_env
    rc = _ckptr(url, store, tmp, upload_retries=1, max_to_keep=2)
    states = _states(4)
    store.fail_puts = 10_000
    for s in states[:3]:
        assert rc.save(s)
        rc._uploader.join()
    assert 1 not in rc._pending_steps()
    store.fail_puts = 0
    assert rc.save(states[3], block=True)
    assert not rc._failed_steps and rc._remote_steps() == [3, 4]
    rc.close()


def test_uncommitted_staging_steps_purged_at_init(remote_env):
    url, store, tmp = remote_env
    rc = _ckptr(url, store, tmp)
    s1, s2 = _states(2)
    rc.save(s1, block=True)
    rc.save(s2, block=True)
    rc.close()
    store.delete(f"{url}/{_MARKER}2")  # a crash mid-upload: no marker
    rc2 = _ckptr(url, store, tmp)
    assert rc2.latest_step() == 1
    assert not os.path.isdir(str(tmp / "staging" / "2"))
    restored = rc2.restore(create_train_state(CFG, "cpu"))
    assert restored.step == 1
    for k, v in s1.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    rc2.close()


def test_retention_deletes_marker_first(remote_env):
    url, store, tmp = remote_env
    deletes = []
    real_delete = store.delete

    def tracking_delete(u):
        deletes.append(u)
        real_delete(u)

    store.delete = tracking_delete
    rc = _ckptr(url, store, tmp, max_to_keep=2)
    for s in _states(3):
        rc.save(s, block=True)
    assert rc._remote_steps() == [2, 3]
    marker = deletes.index(f"{url}/{_MARKER}1")
    tree = [i for i, u in enumerate(deletes) if u.startswith(f"{url}/1/")]
    assert tree and all(marker < i for i in tree)
    rc.close()


def test_upload_failure_does_not_corrupt_remote_index(remote_env):
    url, store, tmp = remote_env
    rc = _ckptr(url, store, tmp, upload_retries=1)
    (s1,) = _states(1)
    real_put = HttpObjectStore.put

    def marker_failing_put(self_store, u, data):
        if _MARKER in u:
            raise ObjectStoreError(f"injected marker failure for {u}")
        real_put(self_store, u, data)

    store.put = marker_failing_put.__get__(store)
    rc.save(s1)
    rc._uploader.join()
    assert rc._remote_steps() == [] and rc._failed_steps == {1}
    with pytest.raises(ObjectStoreError, match="injected marker"):
        rc.close()
    rc.close()


def test_a_url_model_dir_is_single_process(remote_env):
    url, _, tmp = remote_env
    with pytest.raises(ValueError, match="single-process"):
        RemoteCheckpointer(url, staging_dir=str(tmp / "s"),
                           ctx=types.SimpleNamespace(world_size=2))


def test_the_train_task_resumes_from_a_url_model_dir_bit_for_bit(remote_env, monkeypatch):
    """Two epochs against the URL model_dir, then two more resumed from it,
    equal four epochs on a local directory; every remote step has its
    marker."""
    from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr
    from deepfm_tpu_torch.train import loop

    url, _, tmp = remote_env
    monkeypatch.setenv("TMPDIR", str(tmp / "tmp"))
    os.makedirs(tmp / "tmp")
    data = tmp / "data"
    data.mkdir()
    generate_synthetic_ctr(data / "train-0.tfrecords", num_records=64, feature_size=80,
                           field_size=4, seed=1)
    base = CFG.with_overrides(data={"training_data_dir": str(data), "batch_size": 16},
                              run={"checkpoint_every_steps": 2, "log_steps": 100})

    def run(model_dir, epochs):
        return loop.run_train(base.with_overrides(run={"model_dir": model_dir},
                                                  data={"num_epochs": epochs}), device="cpu")

    run(url, 2)
    got = run(url, 4)
    want = run(str(tmp / "local"), 4)
    assert got.step == want.step == 16
    for k, v in want.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k
    for name, slots in want.optimizer.slots.items():
        for s, t in slots.items():
            assert torch.equal(got.optimizer.slots[name][s], t), (name, s)
    steps = RemoteCheckpointer(url, staging_dir=str(tmp / "fresh"))._remote_steps()
    assert steps == [12, 14, 16]
    listed = HttpObjectStore().list_prefix(url + "/")
    for s in steps:
        assert f"{url}/{_MARKER}{s}" in listed and f"{url}/{s}/state.pt" in listed
