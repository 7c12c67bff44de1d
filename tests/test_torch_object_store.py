"""The port's S3-wire client and dev store (deepfm_tpu_torch/data/
object_store.py, utils/dev_object_store.py) crossed with JAX's: each
scenario runs with the port's client against JAX's server, JAX's client
against the port's server and JAX against JAX, and the three transcripts
(bytes read, listings, error statuses and retry verdicts, fault counters)
are equal.  Scenarios: get/put/head/delete, ranged and resumed reads (a
body cut mid-stream), ListObjectsV2 pagination at max_keys=2,
delete_prefix, upload_tree/download_tree, FaultPlan-injected 5xx retried
to success and past the retry budget, and a 404 failing fast."""

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
