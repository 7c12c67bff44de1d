"""The port's tiered store (deepfm_tpu_torch/tiered) on the CPU, with JAX's
``tests/test_tiered.py`` as referee, at JAX's ``V, F, K, B = 512, 8, 8,
32``:

* the paged step equals the port's resident lazy step with zero tolerance
  (losses, tables, moments, the rest of the model) with a hot cache of one
  batch (evictions every step), and across a save, a cache-cold restore
  and the rest of the run;
* the port's ``TieredTrainer`` against JAX's on the same initial weights,
  within the tolerance ``tests/test_torch_lazy.py`` uses (float32 MLP,
  dropout off: loss 1e-5 relative, tables and moments 1e-5 absolute);
* the tiers: ranged page reads, the overlay and copy-on-write, the host
  tier's eviction flush, files of one package read by the other, and an
  object-store root raising (ROADMAP A15);
* the train task with ``--set model.tiered_embeddings=true`` through
  ``python -m deepfm_tpu_torch --device cpu``: checkpoints, a resume, the
  publish and a scorer of it;
* ``publish_tiered``'s pinned snapshot while the trainer goes on, and the
  paging gauges in ``/v1/metrics`` and ``/metrics``;
* JAX's refusals and warnings, and ``probe_ids`` at ids of 2**24.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.tiered import TieredTrainer as JaxTieredTrainer
from deepfm_tpu.tiered.store import ColdTier as JaxColdTier
from deepfm_tpu.tiered.store import RecordLayout as JaxRecordLayout
from deepfm_tpu.train.step import create_train_state as jax_create_train_state
from deepfm_tpu_torch.convert import params_from_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.online.publisher import ModelPublisher, latest_manifest
from deepfm_tpu_torch.tiered import TieredScorer, TieredTrainer
from deepfm_tpu_torch.tiered.host import HostTier
from deepfm_tpu_torch.tiered.store import ColdTier, RecordLayout
from deepfm_tpu_torch.train.step import create_train_state, predict_step, train_step

V, F, K, B = 512, 8, 8, 32
SIZES = dict(capacity=B * F, stage_rows=B * F, host_rows=2 * V)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jcfg(**model_over) -> JaxConfig:
    return JaxConfig.from_dict({
        "model": {"feature_size": V, "field_size": F, "embedding_size": K,
                  "deep_layers": (16, 8), "dropout_keep": (0.5, 0.5),
                  "fused_kernel": "off", "tiered_embeddings": True,
                  "tiered_page_rows": 64, **model_over},
        "optimizer": {"lazy_embedding_updates": True, "learning_rate": 5e-3},
        "data": {"batch_size": B},
    })


def _cfg(**model_over) -> Config:
    return Config.from_dict(_jcfg(**model_over).to_dict())


def _batches(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"feat_ids": rng.integers(0, V, (B, F)).astype(np.int64),
             "feat_vals": rng.random((B, F), dtype=np.float32),
             "label": (rng.random(B) < 0.3).astype(np.float32)} for _ in range(n)]


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def cfg():
    return _cfg()


@pytest.fixture(scope="module")
def resident(cfg):
    """An uninterrupted resident lazy run: (losses, final state)."""
    state = create_train_state(cfg, "cpu")
    losses = [float(train_step(state, _tensors(b))["loss"]) for b in _batches(10)]
    return losses, state


def _fresh(cfg, tmp_path, **sizes):
    return TieredTrainer.from_resident_state(cfg, create_train_state(cfg, "cpu"),
                                             str(tmp_path / "cold"), **(sizes or SIZES))


class TestParity:
    def test_paged_matches_resident_bit_exact(self, cfg, resident, tmp_path):
        res_losses, res_state = resident
        with _fresh(cfg, tmp_path) as tr:
            losses = [float(tr.train_batch(b)["loss"]) for b in _batches(10)]
            assert losses == res_losses
            stats = tr.pager.stats()
            assert stats["evictions"] > 0 and stats["writeback_rows"] > 0
            assert 0 < stats["hit_rate"] < 1
            rows, m, v = tr.export_tables()
            for k in ("fm_w", "fm_v"):
                assert np.array_equal(rows[k], getattr(res_state.model, k).detach().numpy()), k
                assert np.array_equal(m[k], res_state.lazy.m[k].numpy()), k
                assert np.array_equal(v[k], res_state.lazy.v[k].numpy()), k
            want = dict(res_state.model.named_parameters())
            for name, p in tr.state.model.named_parameters():
                if name not in ("fm_w", "fm_v"):
                    assert torch.equal(p, want[name]), name
            assert tr.state.step == res_state.step == 10
            assert tr.state.optimizer.count == res_state.optimizer.count

    def test_crash_resume_restores_cache_cold(self, cfg, resident, tmp_path):
        res_losses, _ = resident
        batches = _batches(10)
        ckpt = str(tmp_path / "ckpt")
        with _fresh(cfg, tmp_path) as tr:
            losses = [float(tr.train_batch(b)["loss"]) for b in batches[:5]]
            meta = tr.save(ckpt)
        assert meta["step"] == 5 and meta["cold"]["page_versions"]
        with TieredTrainer.restore(cfg, ckpt, device="cpu", **SIZES) as tr2:
            assert tr2.state.step == 5
            s = tr2.pager.stats()
            assert s["hits"] == 0 and s["steps"] == 0  # cache-cold
            losses += [float(tr2.train_batch(b)["loss"]) for b in batches[5:]]
            assert tr2.pager.stats()["misses"] > 0
        assert losses == res_losses

    def test_the_port_matches_jax_tiered_trainer(self, tmp_path):
        """JAX's TieredTrainer and the port's from the same initial weights
        (float32 MLP, dropout off), cache of one batch: per-step losses and
        the final tables, moments and MLP within the lazy tests' 1e-5."""
        jcfg = _jcfg(dropout_keep=(1.0, 1.0), compute_dtype="float32")
        cfg = Config.from_dict(jcfg.to_dict())
        jstate = jax_create_train_state(jcfg)
        params = jax.tree_util.tree_map(np.asarray, jstate.params)
        mstate = jax.tree_util.tree_map(np.asarray, jstate.model_state)
        state = create_train_state(cfg, "cpu")
        state.model.load_state_dict(params_from_jax(params, mstate, cfg.model))
        batches = _batches(8, seed=4)
        with JaxTieredTrainer.from_resident_state(jcfg, jstate, str(tmp_path / "jcold"),
                                                  **SIZES) as jtr, \
                TieredTrainer.from_resident_state(cfg, state, str(tmp_path / "cold"),
                                                  **SIZES) as tr:
            for b in batches:
                want = float(jtr.train_batch(b)["loss"])
                got = float(tr.train_batch(b)["loss"])
                np.testing.assert_allclose(got, want, rtol=1e-5)
            assert tr.pager.stats()["evictions"] == jtr.pager.stats()["evictions"] > 0
            got, want = tr.export_tables(), jtr.export_tables()
            for g, w, part in zip(got, want, ("rows", "m", "v")):
                for k in ("fm_w", "fm_v"):
                    np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5,
                                               err_msg=f"{part} {k}")
            # JAX's paged state keeps the rest of the model; its tables fill
            # in from the initial weights (they are compared above)
            rest = params_from_jax({**params, **jax.tree_util.tree_map(
                np.asarray, jtr.state.rest)}, mstate, cfg.model)
            for name, p in tr.state.model.named_parameters():
                if name not in ("fm_w", "fm_v"):
                    np.testing.assert_allclose(p.detach().numpy(), rest[name].numpy(),
                                               rtol=0, atol=1e-5, err_msg=name)


class TestTiers:
    def _layout(self):
        return RecordLayout({"fm_w": 1, "fm_v": 4})

    def _dense(self, rows):
        rng = np.random.default_rng(0)
        mk = lambda w: {  # noqa: E731
            "fm_w": rng.random(rows).astype(np.float32) + w,
            "fm_v": rng.random((rows, 4)).astype(np.float32) + w,
        }
        return mk(0), mk(1), mk(2)

    def test_ranged_page_reads_match_import(self, tmp_path):
        rows, mm, vv = self._dense(100)
        cold = ColdTier(str(tmp_path), rows=100, layout=self._layout(), page_rows=16,
                        pages_per_segment=2)
        assert cold.import_dense(rows, mm, vv) == -(-100 // 32)
        assert cold.page_len(cold.num_pages - 1) == 4
        r2, m2, v2 = cold.export_dense()
        for k in ("fm_w", "fm_v"):
            np.testing.assert_array_equal(r2[k], rows[k])
            np.testing.assert_array_equal(m2[k], mm[k])
            np.testing.assert_array_equal(v2[k], vv[k])
        # a page read reads its span only: one page's bytes
        before = cold.stats()["cold_read_bytes"]
        cold.read_page(3)
        assert cold.stats()["cold_read_bytes"] - before == 16 * 15 * 4

    def test_each_package_reads_the_others_files(self, tmp_path):
        """The record layout, segment and overlay files are JAX's: a table
        the port imports and overlays reads back through JAX's ColdTier,
        and the other way round."""
        rows, mm, vv = self._dense(100)
        port = ColdTier(str(tmp_path / "p"), rows=100, layout=self._layout(), page_rows=16)
        port.import_dense(rows, mm, vv)
        patched = port.read_page(2)
        patched[1] = 9.0
        port.write_page(2, patched)
        jax_side = JaxColdTier(str(tmp_path / "p"), rows=100,
                               layout=JaxRecordLayout({"fm_w": 1, "fm_v": 4}), page_rows=16,
                               page_versions={int(p): v for p, v in
                                              port.snapshot()["page_versions"].items()})
        for page in range(port.num_pages):
            np.testing.assert_array_equal(jax_side.read_page(page), port.read_page(page))
        jcold = JaxColdTier(str(tmp_path / "j"), rows=100,
                            layout=JaxRecordLayout({"fm_w": 1, "fm_v": 4}), page_rows=16)
        jcold.import_dense(rows, mm, vv)
        again = ColdTier(str(tmp_path / "j"), rows=100, layout=self._layout(), page_rows=16)
        for page in range(again.num_pages):
            np.testing.assert_array_equal(again.read_page(page), jcold.read_page(page))
        assert port.snapshot().keys() == jcold.snapshot().keys()

    def test_overlay_wins_and_cow_pins_old_readers(self, tmp_path):
        rows, mm, vv = self._dense(64)
        cold = ColdTier(str(tmp_path), rows=64, layout=self._layout(), page_rows=16)
        cold.import_dense(rows, mm, vv)
        before = cold.snapshot()
        page0 = cold.read_page(0)
        patched = page0.copy()
        patched[3, :] = 42.0
        cold.write_page(0, patched)
        np.testing.assert_array_equal(cold.read_page(0), patched)
        pinned = ColdTier(str(tmp_path), rows=64, layout=self._layout(), page_rows=16,
                          page_versions={int(p): int(v) for p, v in
                                         before["page_versions"].items()})
        np.testing.assert_array_equal(pinned.read_page(0), page0)
        patched2 = patched.copy()
        patched2[5, :] = -1.0
        cold.write_page(0, patched2)
        assert cold.gc_overlays() == 1
        np.testing.assert_array_equal(cold.read_page(0), patched2)

    def test_host_tier_eviction_flushes_dirty(self, tmp_path):
        rows, mm, vv = self._dense(256)
        cold = ColdTier(str(tmp_path), rows=256, layout=self._layout(), page_rows=16)
        cold.import_dense(rows, mm, vv)
        host = HostTier(cold, capacity_rows=32)
        recs = host.get_records(np.arange(16))
        np.testing.assert_array_equal(recs, cold.read_page(0))
        dirty = recs[5].copy() * 0 + 7.0
        host.put_records(np.asarray([5]), dirty[None])
        for lo in range(16, 256, 16):
            host.get_records(np.arange(lo, lo + 16))
        assert host.stats()["host_evictions"] > 0
        assert host.stats()["host_flushed_rows"] >= 1
        np.testing.assert_array_equal(cold.read_page(0)[5], dirty)

    def test_a_read_keeps_its_rows_against_a_prefetch(self, tmp_path):
        """The next step's prefetch, run between a read's page fetches (as
        the trainer's prefetch thread runs), neither evicts the read's
        rows nor refetches its own.  Both fills stamp their rows with the
        same use clock, so once the two outgrow the tier each used to
        evict the other's fresh rows and refetch them forever."""
        rows, mm, vv = self._dense(1024)
        cold = ColdTier(str(tmp_path), rows=1024, layout=self._layout(), page_rows=16)
        cold.import_dense(rows, mm, vv)
        host = HostTier(cold, capacity_rows=64)
        read, prefetches, nested = cold.read_page, [], []

        def read_page(page):
            if not nested and len(prefetches) < 100:
                nested.append(True)
                try:
                    ahead = np.arange(512, 560) + 64 * (len(prefetches) % 2)
                    prefetches.append(host.prefetch(ahead))
                finally:
                    nested.clear()
            return read(page)

        cold.read_page = read_page
        out = []
        reader = threading.Thread(target=lambda: out.append(host.get_records(np.arange(48))),
                                  daemon=True)
        reader.start()
        reader.join(timeout=60)
        assert not reader.is_alive(), f"the read did not end ({len(prefetches)} prefetches)"
        np.testing.assert_array_equal(out[0], np.concatenate([read(p) for p in range(3)]))
        # one prefetch a page the read fetched: no page was fetched twice
        assert len(prefetches) == 3 and prefetches[0] == 48
        assert not host._pins

    def test_a_fetch_never_inserts_a_row_written_back_during_it(self, tmp_path):
        """A dirty row put, written back and evicted while another thread
        reads its page from the cold tier: the fetch's copy of the page is
        older than the write-back and must not come back as the row's
        value (it used to: a lost update, and a resumed tiered run that
        differed from an uninterrupted one)."""
        rows, mm, vv = self._dense(256)
        cold = ColdTier(str(tmp_path), rows=256, layout=self._layout(), page_rows=16)
        cold.import_dense(rows, mm, vv)
        host = HostTier(cold, capacity_rows=64)
        read, raced = cold.read_page, []
        fresh = np.full((1, cold.layout.width), 7.0, np.float32)

        def read_page(page):
            stale = read(page)
            if page == 0 and not raced:
                raced.append(True)
                host.put_records(np.array([3]), fresh)
                with host._cond:  # the eviction of row 3: written back, dropped
                    i = host._idx_of.pop(3)
                    host._flush_indices_locked(np.array([i]))
                    host._row_at[i] = -1
                    host._free.append(i)
            return stale

        cold.read_page = read_page
        got = host.get_records(np.arange(8))
        assert raced
        np.testing.assert_array_equal(got[3], fresh[0])
        np.testing.assert_array_equal(np.delete(got, 3, axis=0), np.delete(read(0)[:8], 3, axis=0))

    def test_an_object_store_root_raises(self, tmp_path):
        with pytest.raises(NotImplementedError, match="A15"):
            ColdTier("http://127.0.0.1:9/bucket/cold", rows=10, layout=self._layout())
        with pytest.raises(ValueError, match="tiered_cold_url.*A15"):
            _cfg(tiered_cold_url="s3://bucket/cold")


class TestTrainTask:
    def test_run_train_tiered_through_the_cli(self, tmp_path):
        """``python -m deepfm_tpu_torch --set model.tiered_embeddings=true``:
        a virtual cold tier, paged checkpoints every 3 steps, the publish;
        the same command again resumes at the end and trains nothing."""
        from deepfm_tpu_torch.data import generate_synthetic_ctr

        generate_synthetic_ctr(tmp_path / "tr-0.tfrecords", num_records=128,
                               feature_size=V, field_size=F, seed=1)
        argv = [sys.executable, "-m", "deepfm_tpu_torch", "--task_type", "train",
                "--device", "cpu", "--training_data_dir", str(tmp_path),
                "--model_dir", str(tmp_path / "model"),
                "--servable_model_dir", str(tmp_path / "pub"), "--feature_size", str(V),
                "--field_size", str(F), "--embedding_size", str(K), "--deep_layers", "16,8",
                "--dropout", "1.0,1.0", "--batch_size", str(B), "--num_epochs", "2",
                "--set", "model.tiered_embeddings=true",
                "--set", f"model.tiered_hot_slots={B * F}",
                "--set", f"model.tiered_stage_rows={B * F}",
                "--set", f"model.tiered_host_rows={2 * V}",
                "--set", "model.tiered_page_rows=64",
                "--set", "optimizer.lazy_embedding_updates=true",
                "--set", "run.checkpoint_every_steps=3", "--set", "run.log_steps=100"]
        env = {**os.environ, "PYTHONPATH": ROOT}

        def run():
            out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                                 timeout=300)
            assert out.returncode == 0, out.stderr[-2000:]
            return [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]

        lines = run()
        done = [x for x in lines if x["kind"] == "tiered_done"][0]
        assert done["step"] == done["steps"] == 128 * 2 // B
        assert 0 <= done["hit_rate"] <= 1
        man = latest_manifest(str(tmp_path / "pub"))
        assert man.step == 8 and man.extra["tiered"]["page_versions"]
        assert os.path.isdir(tmp_path / "model" / "cold" / "pages")
        lines = run()
        assert [x["step"] for x in lines if x["kind"] == "resume"] == [8]
        assert [x["steps"] for x in lines if x["kind"] == "tiered_done"] == [0]
        scorer = TieredScorer.from_publish(str(tmp_path / "pub"), str(tmp_path / "staging"),
                                           capacity=B * F, host_rows=2 * V, device="cpu")
        probs = scorer.score_instances([{"feat_ids": list(range(F)), "feat_vals": [1.0] * F}])
        assert probs.shape == (1,) and np.isfinite(probs).all()

    def test_tiered_rejects_a_sharded_mesh(self):
        from deepfm_tpu_torch.train.loop import run_train

        with pytest.raises(RuntimeError, match="single-process"):
            run_train(_cfg().with_overrides(mesh={"model_parallel": 2}), device="cpu")


class TestPublish:
    def test_published_snapshot_is_consistent(self, cfg, tmp_path):
        """publish_tiered pins page_versions; the trainer trains and
        flushes on, and a scorer of the manifest still gives the
        publish-time model's probabilities bit for bit."""
        batches = _batches(10)
        state5 = create_train_state(cfg, "cpu")
        for b in batches[:5]:
            train_step(state5, _tensors(b))
        probe = {k: torch.from_numpy(batches[0][k]) for k in ("feat_ids", "feat_vals")}
        want5 = predict_step(state5.model, probe).numpy()
        pub = ModelPublisher(str(tmp_path / "pub"), keep=3)
        with _fresh(cfg, tmp_path) as tr:
            for b in batches[:5]:
                tr.train_batch(b)
            man = pub.publish_tiered(cfg, tr)
            assert man.step == 5 and man.extra["tiered"]["page_versions"]
            for b in batches[5:]:
                tr.train_batch(b)
            tr.flush()
        scorer = TieredScorer.from_publish(str(tmp_path / "pub"), str(tmp_path / "staging"),
                                           capacity=B * F, host_rows=2 * V, device="cpu")
        np.testing.assert_array_equal(scorer.score(batches[0]["feat_ids"],
                                                   batches[0]["feat_vals"]), want5)
        assert scorer.paging_snapshot()["misses"] > 0

    def test_metrics_carry_the_paging_gauges(self, cfg, tmp_path):
        from deepfm_tpu_torch.serve.server import ScoringHTTPServer, make_handler

        with _fresh(cfg, tmp_path) as tr:
            tr.train_batch(_batches(1)[0])
            ModelPublisher(str(tmp_path / "pub"), keep=1).publish_tiered(cfg, tr)
        scorer = TieredScorer.from_publish(str(tmp_path / "pub"), str(tmp_path / "staging"),
                                           capacity=B * F, host_rows=2 * V, device="cpu")
        server = ScoringHTTPServer(("127.0.0.1", 0), make_handler(scorer, "deepfm"))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            body = json.dumps({"instances": [{"feat_ids": list(range(F)),
                                              "feat_vals": [1.0] * F}]}).encode()
            req = urllib.request.Request(f"{base}/v1/models/deepfm:predict", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                assert len(json.loads(r.read())["predictions"]) == 1
            with urllib.request.urlopen(f"{base}/v1/metrics") as r:
                paging = json.loads(r.read())["paging"]
            for key in ("hit_rate", "hits", "misses", "refill_bytes", "host", "cold"):
                assert key in paging, sorted(paging)
            assert paging["requests"] >= 1
            with urllib.request.urlopen(f"{base}/metrics") as r:
                text = r.read().decode()
            assert 'deepfm_serving_paging{kind="hit_rate"}' in text
            assert 'deepfm_serving_paging{kind="cold.cold_read_bytes"}' in text
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=5)


# each case: model and data overrides, and whether JAX and the port raise
# (ValueError) or warn at config time
REFUSALS = [
    ({"fused_kernel": "auto"}, {}, "raise"),
    ({"tiered_hot_slots": B * F - 1}, {}, "raise"),
    ({"tiered_host_rows": B * F}, {}, "raise"),
    ({"tiered_page_rows": 0}, {}, "raise"),
    ({"tiered_stage_rows": -1}, {}, "raise"),
    ({"tiered_stage_rows": B * F - 1}, {}, "warn"),
]


@pytest.mark.parametrize("model,data,kind", REFUSALS,
                         ids=[next(iter(m)) + f"-{k}" for m, _, k in REFUSALS])
def test_the_config_refuses_what_jax_refuses(model, data, kind):
    sections = {"model": {**_jcfg().to_dict()["model"], **model},
                "optimizer": {"lazy_embedding_updates": True}, "data": {"batch_size": B}}
    if kind == "raise":
        with pytest.raises(ValueError):
            JaxConfig.from_dict(sections)
        with pytest.raises(ValueError):
            Config.from_dict(json.loads(json.dumps(sections, default=list)))
    else:
        with pytest.warns(UserWarning, match="tiered_stage_rows"):
            JaxConfig.from_dict(sections)
        with pytest.warns(UserWarning, match="tiered_stage_rows"):
            Config.from_dict(json.loads(json.dumps(sections, default=list)))


def test_the_trainer_refuses_what_jax_refuses(tmp_path):
    sgd = _cfg().with_overrides(optimizer={"name": "Adagrad"})
    with pytest.raises(ValueError, match="must be Adam"):
        TieredTrainer.create_virtual(sgd, str(tmp_path / "a"), device="cpu")
    jsgd = _jcfg().with_overrides(optimizer={"name": "Adagrad"})
    with pytest.raises(ValueError, match="must be Adam"):
        JaxTieredTrainer.create_virtual(jsgd, str(tmp_path / "b"))
    with pytest.raises(ValueError, match="LAZY optimizer layout"):
        TieredTrainer.from_resident_state(
            _cfg(), create_train_state(_cfg().with_overrides(
                optimizer={"lazy_embedding_updates": False}), "cpu"), str(tmp_path / "c"))
    with pytest.raises(ValueError, match="cannot hold one batch"):
        TieredTrainer.create_virtual(_cfg(), str(tmp_path / "d"), device="cpu",
                                     capacity=B * F - 1)


class TestProbeStreamHugeVocab:
    """Ids of 2**24 and more through the port's exchange plan: the probe
    stream (``probe_ids``) holds exactly the distinct in-range ids, as
    JAX's does on its packed and its argsort route."""

    @pytest.mark.parametrize("n", [64, 4096])
    def test_probe_ids_at_2pow24(self, n):
        from deepfm_tpu.parallel.embedding import exchange_plan as jax_plan
        from deepfm_tpu.parallel.embedding import probe_ids as jax_probe_ids
        from deepfm_tpu_torch.parallel.embedding import exchange_plan, probe_ids

        total = 1 << 24
        rows, shards = total // 4, 4
        rng = np.random.default_rng(7)
        ids = rng.integers(0, total, n).astype(np.int32)
        high = ids[::max(1, n // 8)]
        ids[::max(1, n // 8)] = total - 1 - np.arange(len(high), dtype=np.int32)
        ids[1] = ids[0]  # a duplicate of a huge id
        row_id, valid = probe_ids(exchange_plan(torch.from_numpy(ids), rows, shards, n))
        got = row_id[valid].numpy()
        want = np.unique(ids.astype(np.int64))
        np.testing.assert_array_equal(got, want)  # ascending, one a distinct id
        j_row, j_valid = jax_probe_ids(jax_plan(jax.numpy.asarray(ids), rows, shards, n))
        np.testing.assert_array_equal(np.sort(np.asarray(j_row)[np.asarray(j_valid)]), got)

    def test_sort_segments_groups_huge_ids_stably(self):
        from deepfm_tpu_torch.ops.embedding import sort_segments

        rng = np.random.default_rng(3)
        ids = rng.integers(0, 1 << 30, 64).astype(np.int64)
        ids[0] = ids[-1] = ids[17] = (1 << 30) - 1
        order, seg, row_id, valid = sort_segments(torch.from_numpy(ids))
        order = order.numpy()
        assert [int(p) for p in order if ids[p] == (1 << 30) - 1] == [0, 17, 63]
        sorted_ids = ids[order]
        assert np.array_equal(row_id.numpy()[seg.numpy()], sorted_ids)
        assert int(valid.sum()) == len(np.unique(ids))


def test_the_observer_prefetches_ahead(cfg, tmp_path):
    from deepfm_tpu_torch.data.pipeline import Prefetcher
    from deepfm_tpu_torch.train.loop import _observed

    with _fresh(cfg, tmp_path) as tr:
        with Prefetcher(_observed(iter(_batches(4, seed=9)), tr.observer()),
                        depth=2) as feed:
            losses = [float(tr.train_batch(b)["loss"]) for b in feed]
        assert len(losses) == 4
        deadline = time.monotonic() + 5
        while tr.host.stats()["prefetched_rows"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert tr.host.stats()["prefetched_rows"] > 0
