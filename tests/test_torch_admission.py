"""The port's serving control plane (deepfm_tpu_torch/serve/control) and
the micro-batcher's deadline path against the JAX package's: the same
scripted clock and load give the same admission and shed decisions, the
same retry hints, cost estimates and snapshots; expired work is answered
at dequeue and never dispatched, in both engines."""

import threading
import time

import numpy as np
import pytest

from deepfm_tpu.serve.batcher import MicroBatcher as JaxBatcher
from deepfm_tpu.serve.control.admission import AdmissionController as JaxAdmission
from deepfm_tpu.serve.control.cost import BucketCostModel as JaxCost
from deepfm_tpu_torch.serve.batcher import MicroBatcher
from deepfm_tpu_torch.serve.control import (AdmissionController, BucketCostModel,
                                            DeadlineRejectedError, ShedError)

# (rows, queued_rows, deadline offset or None, priority, inflight offset or
# None, cost observations before the call): a load that climbs through
# every rung of the ladder and back, with deadlines that the cost model
# prices as meetable, unmeetable, cold and with a dispatch in flight
SCRIPT = [
    (8, 0, None, "predict", None, []),
    (8, 0, 0.010, "predict", None, []),                 # cold: admitted
    (8, 40, 0.100, "predict", None, [(8, 0.050)]),     # drain 250 ms: refused
    (8, 40, 10.0, "predict", None, []),
    (8, 0, 0.150, "predict", 0.020, [(8, 0.100)]),     # a dispatch in flight
    (8, 0, 0.150, "predict", 0.095, []),
    (4, 650, None, "shadow", None, []),                # level 1: shadow sheds
    (4, 650, None, "predict", None, []),
    (4, 800, None, "recommend", None, [(32, 0.2)]),    # level 2
    (4, 950, None, "predict", None, []),               # level 3: predicts shed
    (4, 950, None, "shadow", None, []),
    (4, 700, None, "predict", None, []),               # one step down
    (4, 100, None, "shadow", None, []),                # whole ladder released
    (40, 2000, 0.5, "whatever", None, [(8, 0.001)]),
]


def _run_script(adm_cls, cost_cls):
    adm = adm_cls(cost_cls((8, 32)), util_alpha=1.0, deadline_ms=0.0)
    now = 1000.0
    out = []
    for rows, queued, dl, pri, infl, obs in SCRIPT:
        for b, s in obs:
            adm.cost.observe(b, s)
        kw = dict(rows=rows, queued_rows=queued, max_queue_rows=1000,
                  deadline_s=None if dl is None else now + dl, priority=pri, now=now,
                  inflight=None if infl is None else (8, now - infl))
        try:
            got = adm.check(**kw)
            out.append(("admit", None if got is None else round(got - now, 9)))
        except Exception as e:  # the decision is the exception's kind
            out.append((type(e).__name__, round(e.retry_after_s, 9)))
        out.append((adm.level(), adm.degrade_factor()))
        now += 0.001
    snap = adm.snapshot()
    return out, snap


def test_admission_and_shed_decisions_match_jax():
    port, port_snap = _run_script(AdmissionController, BucketCostModel)
    jax, jax_snap = _run_script(JaxAdmission, JaxCost)
    assert port == jax
    assert port_snap == jax_snap
    kinds = [d[0] for d in port[::2]]
    assert kinds.count("ShedError") == 4 and kinds.count("DeadlineRejectedError") == 1
    assert port_snap["sheds_total"] == {"shadow": 2, "recommend": 0, "predict": 2}


def test_cost_model_estimates_match_jax():
    ests = []
    for cls in (BucketCostModel, JaxCost):
        m = cls((8, 32, 128), alpha=0.3)
        row = [m.dispatch_estimate_s(4), m.drain_estimate_s(0), m.drain_estimate_s(50)]
        for b, s in ((8, 0.01), (8, 0.02), (128, 0.2), (128, 0.1)):
            m.observe(b, s)
        row += [m.dispatch_estimate_s(n) for n in (1, 9, 33, 129, 500)]
        row += [m.drain_estimate_s(n) for n in (0, 7, 130, 1000)]
        row.append(m.snapshot())
        ests.append(row)
    assert ests[0] == ests[1]
    assert ests[0][0] is None and ests[0][2] is None  # cold: no guess


def test_admission_config_default_deadline_and_errors():
    adm = AdmissionController(BucketCostModel((8,)), deadline_ms=250.0)
    assert adm.check(rows=8, queued_rows=4000, max_queue_rows=100000,
                     deadline_s=None, now=5.0) == pytest.approx(5.25)
    assert issubclass(ShedError, DeadlineRejectedError)
    with pytest.raises(ValueError, match="ordered"):
        AdmissionController(BucketCostModel((8,)), shed_shadow_util=0.9, degrade_util=0.5)


def _stale_bucket(cls):
    calls = []

    def fn(ids, vals):
        calls.append(ids.shape[0])
        return np.arange(ids.shape[0], dtype=np.float32)

    mb = cls(fn, 4, buckets=(8,), max_wait_ms=20.0)
    errs, out = [], []
    try:
        stale = time.perf_counter() - 1.0  # expired before it was queued

        def submit_stale():
            try:
                mb.score(np.zeros((1, 4), np.int64), np.zeros((1, 4), np.float32),
                         deadline_s=stale)
            except Exception as e:  # each package's DeadlineExpiredError
                errs.append(type(e).__name__)

        def submit_live():
            out.append(mb.score(np.zeros((2, 4), np.int64), np.zeros((2, 4), np.float32)))

        threads = [threading.Thread(target=submit_stale) for _ in range(7)]
        threads.append(threading.Thread(target=submit_live))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        snap = mb.metrics_snapshot()
    finally:
        mb.close()
    return calls, errs, [o.tolist() for o in out], snap


@pytest.mark.parametrize("cls", [MicroBatcher, JaxBatcher], ids=["port", "jax"])
def test_expired_chunks_answer_504_and_backfill(cls):
    """Seven stale one-row requests and one live two-row request: the stale
    ones are answered at dequeue, the live one is scored, and no dispatch
    carries an expired row (in both engines)."""
    calls, expired, out, snap = _stale_bucket(cls)
    assert expired == ["DeadlineExpiredError"] * 7 and out == [[0.0, 1.0]]
    assert sum(calls) == 8 * len(calls) and snap["expired_total"] == 7
    assert snap["rows_total"] == 9 and snap["queue_rows"] == 0
    assert snap["padded_rows_total"] == 8 * len(calls) - 2


def test_engine_prices_admission_and_feeds_the_cost_model():
    """With a controller attached, the engine stamps the effective deadline,
    feeds its dispatch times to the cost model and reports the admission
    snapshot; an unmeetable deadline is refused before it is queued."""
    gate = threading.Event()

    def fn(ids, vals):
        gate.wait(timeout=30)
        return np.zeros(ids.shape[0], np.float32)

    adm = AdmissionController(BucketCostModel((4,)), util_alpha=0.001)
    mb = MicroBatcher(fn, 2, buckets=(4,), max_wait_ms=0.0, admission=adm)
    try:
        gate.set()
        mb.score(np.ones((3, 2)), np.ones((3, 2)))
        assert adm.cost.snapshot()["observations_total"] == 1
        adm.cost.observe(4, 10.0)  # a dispatch now takes 10 s
        with pytest.raises(DeadlineRejectedError):
            mb.score(np.ones((3, 2)), np.ones((3, 2)),
                     deadline_s=time.perf_counter() + 0.5)
        snap = mb.metrics_snapshot()
        assert snap["requests_total"] == 1 and snap["admission"]["deadline_rejected_total"] == 1
    finally:
        mb.close()
