"""The port's S3-wire client and dev store (deepfm_tpu_torch/data/
object_store.py, utils/dev_object_store.py) crossed with JAX's: each
scenario runs with the port's client against JAX's server, JAX's client
against the port's server and JAX against JAX, and the three transcripts
(bytes read, listings, error statuses and retry verdicts, fault counters)
are equal.  Scenarios: get/put/head/delete, ranged and resumed reads (a
body cut mid-stream), ListObjectsV2 pagination at max_keys=2,
delete_prefix, upload_tree/download_tree, FaultPlan-injected 5xx retried
to success and past the retry budget, and a 404 failing fast.

Then the data plane on the port's dev store, held against JAX's on the
same objects (as ``tests/test_object_store.py`` drives JAX's):
``discover_files`` over a URL, remote batches equal to local ones on the
Python route and through FifoBridge into the C++ reader, a missing object
loud on both, parallel readers over URLs, a dropped GET resumed by the
bridge at its exact offset, an unread bridge reaped and a failed one
raising at ``finish()``, ``write_predictions`` to a URL, the train task
with URL data and a URL model_dir from JAX's initial weights (JAX's steps
and weights within 1e-5, its infer's pred.txt in the store), the CLI
passing URL roots through unchanged, and the join's CLI on URL roots."""

import json
import os

import pytest

from deepfm_tpu.data import object_store as jax_os
from deepfm_tpu.utils import dev_object_store as jax_dev
from deepfm_tpu.utils.retry import RetryPolicy as JaxRetry
from deepfm_tpu_torch.data import object_store as port_os
from deepfm_tpu_torch.utils import dev_object_store as port_dev
from deepfm_tpu_torch.utils.retry import RetryPolicy as PortRetry

PAIRS = {"port-client/jax-server": (port_os, PortRetry, jax_dev),
         "jax-client/port-server": (jax_os, JaxRetry, port_dev),
         "jax-client/jax-server": (jax_os, JaxRetry, jax_dev)}


def _err(e: BaseException) -> tuple:
    return (type(e).__name__, getattr(e, "status", None), getattr(e, "retryable", None))


def _get_put_head_delete(store, base, plan, tmp):
    url = f"{base}/bucket/a/b.bin"
    data = bytes(range(256)) * 40
    store.put(url, data)
    out = [store.get(url) == data, store.exists(url), store.size(url)]
    store.delete(url)
    out += [store.exists(url), store.delete(url)]
    try:
        store.get(url)
    except Exception as e:
        out.append(_err(e))
    return out


def _ranged_and_resumed(store, base, plan, tmp):
    url = f"{base}/bucket/seg"
    data = bytes(i % 251 for i in range(50_000))
    store.put(url, data)
    out = [store.get_range(url, 1000, 333) == data[1000:1333],
           store.get_range(url, 49_990, 100) == data[49_990:],
           store.get_range(url, 5, 0)]
    with store.open_read(url, offset=7, length=9) as r:
        out.append(r.read() == data[7:16])
    plan.add(verb="GET", key="bucket/seg", times=2, truncate=0.3)
    with store.open_read_resuming(url, offset=100) as r:
        got = b"".join(iter(lambda: r.read(4096), b""))
    out += [got == data[100:], plan.to_dict()["fired_total"]]
    return out


def _pagination_and_prefix(store, base, plan, tmp):
    for i in range(7):
        store.put(f"{base}/bucket/p/k{i}", b"x" * i)
    store.put(f"{base}/bucket/q/other", b"y")
    listed = [u[len(base):] for u in store.list_prefix(f"{base}/bucket/p/")]
    n = store.delete_prefix(f"{base}/bucket/p/")
    return [listed, n, [u[len(base):] for u in store.list_prefix(f"{base}/bucket/")],
            store.list_prefix(f"{base}/empty/")]


def _trees(store, base, plan, tmp):
    src = tmp / "src"
    (src / "d").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"alpha")
    (src / "d" / "b.bin").write_bytes(b"\x00\x01" * 3000)
    up = sorted(u[len(base):] for u in store.upload_tree(str(src), f"{base}/bucket/tree"))
    down = store.download_tree(f"{base}/bucket/tree", str(tmp / "dst"))
    return [up, sorted(os.path.relpath(p, tmp / "dst") for p in down),
            (tmp / "dst" / "d" / "b.bin").read_bytes() == (src / "d" / "b.bin").read_bytes()]


def _faults(store, base, plan, tmp):
    url = f"{base}/bucket/f"
    plan.add(verb="PUT", key="bucket/f", times=2, status=503)
    store.put(url, b"ok")  # two 503s, then the third attempt lands
    out = [store.get(url), plan.to_dict()["rules"][0]["fired"]]
    plan.add(verb="GET", key="bucket/f", times=-1, status=500)
    try:
        store.get(url)
    except Exception as e:
        out.append(_err(e))
    out.append(plan.to_dict()["rules"][1]["fired"])
    plan.clear()
    plan.add(verb="HEAD", key="bucket/f", times=1, status=403)
    try:
        store.size(url)
    except Exception as e:
        out += [_err(e), plan.to_dict()["rules"][0]["fired"]]
    return out


SCENARIOS = {f.__name__.strip("_"): f for f in (_get_put_head_delete, _ranged_and_resumed,
                                                 _pagination_and_prefix, _trees, _faults)}


def _transcript(pair: str, scenario, tmp_path):
    client, retry, dev = PAIRS[pair]
    root = tmp_path / pair / "root"
    root.mkdir(parents=True)
    server, base = dev.serve(str(root), max_keys=2)
    try:
        store = client.HttpObjectStore(timeout=10, retry=retry(
            max_attempts=3, base_delay_secs=0.0, max_delay_secs=0.0))
        return scenario(store, base, server.fault_plan, tmp_path / pair)
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_the_clients_and_servers_agree_crossed(tmp_path, name):
    got = {pair: _transcript(pair, SCENARIOS[name], tmp_path) for pair in PAIRS}
    want = got.pop("jax-client/jax-server")
    for pair, t in got.items():
        assert t == want, pair


def test_url_helpers_and_open_source(tmp_path):
    assert port_os.is_url("http://h/b/k") and not port_os.is_url("/a/b")
    assert port_os.join_url("http://h/b/", "/x/", "y") == jax_os.join_url("http://h/b/", "/x/", "y")
    with pytest.raises(ValueError, match="bucket"):
        port_os.HttpObjectStore().list_prefix("http://127.0.0.1:1/")
    (tmp_path / "f").write_bytes(b"0123456789")
    with port_os.open_source(str(tmp_path / "f"), offset=4) as f:
        assert f.read() == b"456789"
    server, base = port_dev.serve(str(tmp_path / "root"))
    try:
        port_os.get_store().put(f"{base}/b/k", b"abcdef")
        with port_os.open_source(f"{base}/b/k", offset=2) as f:
            assert f.read() == b"cdef"
        prev = port_os.set_store(port_os.HttpObjectStore(timeout=1))
        assert port_os.get_store() is not prev
        port_os.set_store(prev)
        assert port_os.get_store() is prev
    finally:
        server.shutdown()
        server.server_close()


# ------------------------------------------------ the data plane on a store

FEATURE, FIELD = 300, 6


@pytest.fixture()
def data_store(tmp_path):
    """The port's dev store with two training files and a validation file
    uploaded under ``bucket/ds`` (and their local copies)."""
    from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr

    root = tmp_path / "store_root"
    (root / "bucket").mkdir(parents=True)
    server, base = port_dev.serve(str(root), max_keys=3)
    local = tmp_path / "ds_local"
    local.mkdir()
    store = port_os.HttpObjectStore(timeout=10)
    for name, n, seed in (("tr-0.tfrecords", 96, 0), ("tr-1.tfrecords", 96, 1),
                          ("tr-2.tfrecords", 40, 2), ("va-0.tfrecords", 50, 9)):
        generate_synthetic_ctr(local / name, num_records=n, feature_size=FEATURE,
                               field_size=FIELD, seed=seed)
        store.put(f"{base}/bucket/ds/{name}", (local / name).read_bytes())
    store.put(f"{base}/bucket/ds/notes.txt", b"not a record file")
    try:
        yield {"base": base, "url": f"{base}/bucket/ds", "local": local, "store": store,
               "server": server}
    finally:
        server.shutdown()
        server.server_close()


def _same_batches(got, want):
    import numpy as np

    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for k in ("feat_ids", "feat_vals", "label"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_discover_files_over_a_url_equals_local_and_jax(data_store):
    from deepfm_tpu.data.pipeline import discover_files as jax_discover
    from deepfm_tpu_torch.data.pipeline import discover_files

    url, local = data_store["url"], str(data_store["local"])
    names = lambda files: [f.rsplit("/", 1)[-1] for f in files]  # noqa: E731
    remote = discover_files(url, shuffle=False)
    assert names(remote) == ["tr-0.tfrecords", "tr-1.tfrecords", "tr-2.tfrecords"]
    assert remote == jax_discover(url, shuffle=False)
    for seed in (0, 3):
        shuffled = discover_files(url, shuffle=True, seed=seed)
        assert shuffled == jax_discover(url, shuffle=True, seed=seed)
        assert names(shuffled) == names(discover_files(local, shuffle=True, seed=seed))
    assert names(discover_files(url + "/", ("va",), shuffle=False)) == ["va-0.tfrecords"]


@pytest.mark.parametrize("route", ["python", "native fifo"])
def test_remote_batches_equal_local_ones(data_store, route):
    from deepfm_tpu.data.pipeline import ctr_batches_from_sources as jax_batches
    from deepfm_tpu_torch.data.pipeline import InMemoryDataset, ctr_batches_from_sources

    names = ["tr-0.tfrecords", "tr-2.tfrecords"]
    urls = [f"{data_store['url']}/{n}" for n in names]
    paths = [str(data_store["local"] / n) for n in names]
    native = route != "python"
    kw = dict(batch_size=32, field_size=FIELD, drop_remainder=False)
    _same_batches(ctr_batches_from_sources(urls, native=native, **kw),
                  ctr_batches_from_sources(paths, native=native, **kw))
    _same_batches(ctr_batches_from_sources(urls, native=native, **kw),
                  jax_batches(urls, **kw))
    a = InMemoryDataset.from_files(urls, FIELD, native=native)
    b = InMemoryDataset.from_files(paths, FIELD, native=native)
    assert len(a) == 136 and (a.feat_ids == b.feat_ids).all() and (a.label == b.label).all()


@pytest.mark.parametrize("route", ["python", "native fifo"])
def test_a_failed_remote_stream_is_loud(data_store, route):
    from deepfm_tpu_torch.data.pipeline import ctr_batches_from_sources

    missing = f"{data_store['url']}/tr-9.tfrecords"
    with pytest.raises(port_os.ObjectStoreError):
        list(ctr_batches_from_sources([missing], batch_size=16, field_size=FIELD,
                                      native=route != "python"))


def test_parallel_readers_over_urls_give_the_sequential_batches(data_store):
    from deepfm_tpu.data.pipeline import ctr_batches_from_sources as jax_batches
    from deepfm_tpu_torch.data import pipeline

    urls = [f"{data_store['url']}/tr-{i}.tfrecords" for i in range(3)]
    kw = dict(batch_size=32, field_size=FIELD)
    cores = pipeline._host_cpu_count
    try:
        pipeline._host_cpu_count = lambda: 3  # the merger runs on any host
        par = list(pipeline.ctr_batches_from_sources(urls, parallel_readers=3, **kw))
    finally:
        pipeline._host_cpu_count = cores
    _same_batches(par, pipeline.ctr_batches_from_sources(urls, parallel_readers=1, **kw))
    _same_batches(par, jax_batches(urls, **kw))


def _read_bridge(bridge, timeout: float = 60.0) -> bytes:
    """What a reader of ``bridge``'s FIFO gets up to EOF, read on a thread
    joined with a timeout; then the bridge's writer must have ended too, so
    the ``finish()`` after it cannot wait.  A writer that never opens or
    never closes fails the test instead of hanging it (a blocked open is
    released by a writer's open and close)."""
    import threading

    got = bytearray()

    def read():
        with open(bridge.path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 14), b""):
                got.extend(chunk)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout)
    if reader.is_alive():
        bridge.close()
        try:
            os.close(os.open(bridge.path, os.O_WRONLY | os.O_NONBLOCK))
        except OSError:
            pass
        pytest.fail(f"no EOF on {bridge.path} within {timeout} s")
    bridge._thread.join(timeout)
    assert not bridge._thread.is_alive(), "the bridge's writer outlived its reader's EOF"
    return bytes(got)


def test_the_fifo_bridge_resumes_a_dropped_stream(data_store, tmp_path):
    """The dev store cuts the first two GETs of the object at 30% of the
    body (a dropped connection): the bridge resumes each with a ranged
    re-GET from the exact byte offset and the FIFO carries every byte."""
    url = f"{data_store['url']}/tr-0.tfrecords"
    want = (data_store["local"] / "tr-0.tfrecords").read_bytes()
    plan = data_store["server"].fault_plan
    plan.add(verb="GET", key="bucket/ds/tr-0.tfrecords", times=2, truncate=0.3)
    (tmp_path / "fifos").mkdir()
    bridge = port_os.FifoBridge(url, str(tmp_path / "fifos"), "tr-0")
    got = _read_bridge(bridge)
    bridge.finish()
    assert got == want and bridge.bytes == len(want)
    assert bridge.resumes == 2 and plan.to_dict()["fired_total"] == 2


def test_an_unread_bridge_is_reaped_and_a_failed_one_raises(data_store, tmp_path):
    (tmp_path / "fifos").mkdir()
    idle = port_os.FifoBridge(f"{data_store['url']}/tr-0.tfrecords", str(tmp_path / "fifos"),
                              "idle")
    idle.close()  # nobody opened it: the writer stops polling, quietly
    assert not idle._thread.is_alive() and idle.bytes == 0
    gone = port_os.FifoBridge(f"{data_store['url']}/gone.tfrecords",
                              str(tmp_path / "fifos"), "gone")
    assert _read_bridge(gone) == b""  # the reader sees a clean EOF ...
    with pytest.raises(port_os.ObjectStoreError, match="gone.tfrecords"):
        gone.finish()  # ... and finish() makes it loud


def test_write_predictions_to_a_url_equals_jax(data_store):
    import numpy as np

    from deepfm_tpu.serve.export import write_predictions as jax_write
    from deepfm_tpu_torch.serve.export import write_predictions

    probs = [np.array([0.25, 0.5], np.float32), 0.75, np.array([1e-7, 0.9999996])]
    base, store = data_store["base"], data_store["store"]
    assert write_predictions(iter(probs), f"{base}/bucket/out/port.txt") == 5
    assert jax_write(iter(probs), f"{base}/bucket/out/jax.txt") == 5
    assert store.get(f"{base}/bucket/out/port.txt") == store.get(f"{base}/bucket/out/jax.txt")
    assert store.get(f"{base}/bucket/out/port.txt").startswith(b"0.250000\n0.500000\n")


def _train_doc(data_url, model_url, **run) -> dict:
    return {"model": {"feature_size": FEATURE, "field_size": FIELD, "embedding_size": 4,
                      "deep_layers": (8, 4), "dropout_keep": (1.0, 1.0),
                      "compute_dtype": "float32", "fused_kernel": "off"},
            "optimizer": {"learning_rate": 5e-4},
            "data": {"training_data_dir": data_url, "val_data_dir": data_url,
                     "batch_size": 32, "num_epochs": 1},
            "run": {"model_dir": model_url, "servable_model_dir": "",
                    "checkpoint_every_steps": 0, "log_steps": 1000, **run}}


def test_run_train_with_url_data_and_model_dir_equals_jax(data_store, tmp_path):
    """The train task from an S3-style prefix into a URL model_dir, from
    JAX's initial weights carried across: JAX's step count, weights within
    1e-5 of JAX's run over the same URLs, the commit in the store, a second
    epoch resumed from the store; then the infer task writes pred.txt into
    the store, held to JAX's infer of its own checkpoint."""
    import jax
    import numpy as np

    from deepfm_tpu.core.config import Config as JaxConfig
    from deepfm_tpu.parallel import build_mesh, create_spmd_state, make_context
    from deepfm_tpu.train.loop import run_infer as jax_run_infer
    from deepfm_tpu.train.loop import run_train as jax_run_train
    from deepfm_tpu_torch.convert import train_state_from_jax
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.train.loop import run_infer, run_train
    from deepfm_tpu_torch.utils.logging import MetricLogger

    url, base, store = data_store["url"], data_store["base"], data_store["store"]
    numpy = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    jdoc = {**_train_doc(url, f"{base}/bucket/jax_model"),
            "mesh": {"data_parallel": 8, "model_parallel": 1}}
    jcfg = JaxConfig.from_dict(jdoc)
    jstart = create_spmd_state(make_context(jcfg, build_mesh(jcfg.mesh)))
    jstate = jax_run_train(jcfg)
    steps = (96 + 96 + 40) // 32
    cfg = Config.from_dict(_train_doc(url, f"{base}/bucket/model"))
    state = run_train(cfg, device="cpu", log=MetricLogger(log_steps=1000),
                      state=train_state_from_jax(numpy(jstart), cfg, device="cpu"))
    assert state.step == int(jstate.step) == steps
    want = train_state_from_jax(numpy(jstate), cfg, device="cpu")
    for k, v in want.model.state_dict().items():
        np.testing.assert_allclose(state.model.state_dict()[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    names = [u.rsplit("/", 1)[-1] for u in store.list_prefix(f"{base}/bucket/model/")]
    assert f"_COMMIT_{steps}" in names
    # the infer task: va* under the URL, pred.txt into the store, as JAX's
    out = run_infer(cfg, device="cpu", log=MetricLogger())
    assert out == f"{url}/pred.txt"
    jax_run_infer(jcfg, output_path=f"{base}/bucket/jax_pred.txt")
    got = np.array(store.get(out).split(), np.float64)
    want_probs = np.array(store.get(f"{base}/bucket/jax_pred.txt").split(), np.float64)
    assert got.shape == want_probs.shape == (50,)
    np.testing.assert_allclose(got, want_probs, rtol=0, atol=2e-5)
    # a second epoch resumes from the store
    again = run_train(cfg.with_overrides(data={"num_epochs": 2}), device="cpu",
                      log=MetricLogger(log_steps=1000))
    assert again.step == 2 * steps


@pytest.mark.parametrize("task", ["train", "eval", "infer", "serve", "publish",
                                  "online-train", "feedback-train"])
def test_the_cli_passes_url_roots_through_unchanged(task):
    from deepfm_tpu_torch.launch import cli

    u = "http://127.0.0.1:9000/bucket"
    cfg, _ = cli.resolve_config([
        "--task_type", task, "--training_data_dir", f"{u}/ds", "--val_data_dir", f"{u}/va",
        "--test_data_dir", f"{u}/te", "--model_dir", f"{u}/model",
        "--servable_model_dir", f"{u}/publish", "--set", f"run.serve_reload_url={u}/publish",
        "--set", f"flywheel.join_output_url={u}/joined", "--set", "data.stream_mode=true",
        "--set", "data.shuffle_buffer=64", "--set", "data.eval_max_batches=2"])
    assert (cfg.data.training_data_dir, cfg.data.val_data_dir, cfg.data.test_data_dir,
            cfg.run.model_dir, cfg.run.servable_model_dir, cfg.run.serve_reload_url,
            cfg.flywheel.join_output_url) == (
        f"{u}/ds", f"{u}/va", f"{u}/te", f"{u}/model", f"{u}/publish", f"{u}/publish",
        f"{u}/joined")
    assert (cfg.run.task_type, cfg.data.stream_mode, cfg.data.shuffle_buffer,
            cfg.data.eval_max_batches) == (task, True, 64, 2)


def test_the_join_cli_on_url_roots(data_store, capsys):
    from deepfm_tpu_torch.flywheel import serialize_click, serialize_impression
    from deepfm_tpu_torch.flywheel.join import load_state, main
    from deepfm_tpu_torch.online.stream import SegmentWriter

    root = f"{data_store['base']}/bucket/fly"
    imps = SegmentWriter(f"{root}/imps", roll_bytes=0, roll_age_secs=0)
    for i in range(6):
        imps.append(serialize_impression(
            impression_id=f"r{i}#0", trace_id=f"r{i}", tenant="base", model_version=1,
            ids=[i] * FIELD, values=[1.0] * FIELD, score=0.5, deadline_class="default",
            ts_ms=0))
    imps.flush()
    clicks = SegmentWriter(f"{root}/clicks", roll_bytes=0, roll_age_secs=0)
    clicks.append(serialize_click(impression_id="r1#0", ts_ms=0))
    clicks.flush()
    assert main(["--impressions", f"{root}/imps", "--clicks", f"{root}/clicks",
                 "--out", f"{root}/out", "--window", "600", "--drain"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert (stats["positive_total"], stats["negative_total"]) == (1, 5)
    assert load_state(f"{root}/out")["counters"]["emitted"] == 6
