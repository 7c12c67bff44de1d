"""The port's copy of the preemption guard (``deepfm_tpu_torch/launch/
preemption.py``), through the cases ``tests/test_preemption.py`` holds the
JAX module to: the signal flag, escalation on a second signal (re-entrant
too), the pre-guard handler, the crash supervisor's capped, jittered
backoff, and, with the port's train loop on the CPU, a SIGTERM in the
middle of training and one during setup."""

import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from deepfm_tpu_torch.checkpoint import Checkpointer
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr
from deepfm_tpu_torch.launch import preemption as P
from deepfm_tpu_torch.launch.preemption import (PreemptedError, PreemptionGuard,
                                                run_with_restarts)
from deepfm_tpu_torch.parallel import spmd
from deepfm_tpu_torch.train.loop import run_train
from deepfm_tpu_torch.utils.logging import MetricLogger

ROOT = Path(__file__).resolve().parent.parent
V, F = 300, 6


def _cfg(data_dir, model_dir, num_epochs=2) -> Config:
    return Config.from_dict({
        "model": {"feature_size": V, "field_size": F, "embedding_size": 4,
                  "deep_layers": (8, 4), "dropout_keep": (1.0, 1.0),
                  "compute_dtype": "float32"},
        "data": {"training_data_dir": str(data_dir), "batch_size": 32,
                 "num_epochs": num_epochs},
        "run": {"model_dir": str(model_dir), "servable_model_dir": "",
                "checkpoint_every_steps": 0, "log_steps": 1000},
    })


@pytest.fixture
def data_dir(tmp_path):
    generate_synthetic_ctr(tmp_path / "tr-0.tfrecords", num_records=256, feature_size=V,
                           field_size=F, seed=1)
    return tmp_path


def test_guard_flag_via_real_signal():
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    with guard:
        assert not guard.should_stop
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 5
        while not guard.should_stop and time.time() < deadline:
            time.sleep(0.01)
        assert guard.should_stop
    assert signal.getsignal(signal.SIGUSR1) != guard._handle


class _SignalOnFirstStep(MetricLogger):
    """Sends this process a SIGTERM from inside the loop, after the first
    step is counted."""

    def __init__(self):
        super().__init__(log_steps=1000)
        self.fired = False

    def step(self, *a, **kw):
        super().step(*a, **kw)
        if not self.fired:
            self.fired = True
            os.kill(os.getpid(), signal.SIGTERM)


def test_sigterm_checkpoints_and_the_rerun_resumes(data_dir, tmp_path):
    model = tmp_path / "model"
    with pytest.raises(PreemptedError):
        run_train(_cfg(data_dir, model, num_epochs=6), device="cpu",
                  log=_SignalOnFirstStep())
    stopped = Checkpointer(model).latest_step()
    assert stopped == 1, f"expected the checkpoint of step 1, got {stopped}"
    # 256 records / 32 = 8 steps an epoch; the same command finishes
    state = run_train(_cfg(data_dir, model, num_epochs=6), device="cpu")
    assert state.step == 48


def test_sigterm_during_setup_exits_cleanly(data_dir, tmp_path, monkeypatch):
    real = spmd.create_dp_train_state

    def create_then_signal(*a, **kw):
        os.kill(os.getpid(), signal.SIGTERM)  # lands during setup
        return real(*a, **kw)

    monkeypatch.setattr(spmd, "create_dp_train_state", create_then_signal)
    with pytest.raises(PreemptedError):
        run_train(_cfg(data_dir, tmp_path / "model"), device="cpu")
    assert Checkpointer(tmp_path / "model").all_steps() == [0]


def test_second_signal_escalates_to_default_kill():
    code = (
        "import os, signal, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from deepfm_tpu_torch.launch.preemption import PreemptionGuard\n"
        "with PreemptionGuard() as g:\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "    assert g.should_stop\n"
        "    print('FIRST_OK', flush=True)\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "    print('UNREACHABLE', flush=True)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=60)
    assert "FIRST_OK" in r.stdout and "UNREACHABLE" not in r.stdout
    assert r.returncode == -signal.SIGTERM


def test_run_with_restarts_retries_then_succeeds():
    calls = {"n": 0}
    restarts = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "done"

    out = run_with_restarts(flaky, max_restarts=3, backoff_secs=0.01,
                            on_restart=lambda a, e: restarts.append((a, str(e))))
    assert out == "done" and calls["n"] == 3
    assert [a for a, _ in restarts] == [1, 2]


def test_run_with_restarts_exhausts():
    def always_fails():
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError, match="permanent"):
        run_with_restarts(always_fails, max_restarts=2, backoff_secs=0.01)


def test_run_with_restarts_backoff_is_exponential_jittered_capped():
    def always_fails():
        raise RuntimeError("crash")

    def sleeps_for(seed):
        sleeps = []
        with pytest.raises(RuntimeError):
            run_with_restarts(always_fails, max_restarts=5, backoff_secs=1.0,
                              max_backoff_secs=4.0, sleep=sleeps.append,
                              rng=random.Random(seed))
        return sleeps

    sleeps = sleeps_for(7)
    assert len(sleeps) == 5
    for got, cap in zip(sleeps, [1.0, 2.0, 4.0, 4.0, 4.0]):
        assert cap / 2.0 <= got <= cap
    assert sleeps != sleeps_for(8)


def test_run_with_restarts_preempted_not_retried():
    calls = {"n": 0}

    def preempted():
        calls["n"] += 1
        raise PreemptedError("maintenance event")

    with pytest.raises(PreemptedError):
        run_with_restarts(preempted, max_restarts=5, backoff_secs=0.01)
    assert calls["n"] == 1


def test_reentrant_second_signal_escalates_deterministically(monkeypatch):
    calls = []
    monkeypatch.setattr(P, "_escalate", lambda signum: calls.append(signum))
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    real_time = time.time
    fired = {"n": 0}

    def reenter():
        if fired["n"] == 0:
            fired["n"] = 1
            guard._handle(signal.SIGUSR1, None)  # the nested second signal
        return real_time()

    monkeypatch.setattr(P.time, "time", reenter)
    guard._handle(signal.SIGUSR1, None)
    assert guard.should_stop and calls == [signal.SIGUSR1]


def test_second_signal_after_request_stop_still_escalates(monkeypatch):
    calls = []
    monkeypatch.setattr(P, "_escalate", lambda signum: calls.append(signum))
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    guard.request_stop()
    guard._handle(signal.SIGUSR1, None)
    assert calls == [signal.SIGUSR1]


def test_early_handler_repeated_signal_escalates_once(monkeypatch):
    calls = []
    monkeypatch.setattr(P, "_escalate", lambda signum: calls.append(signum))
    sig = signal.SIGUSR2
    try:
        assert P.install_early_handler(signals=(sig,))
        handler = signal.getsignal(sig)
        handler(sig, None)
        assert not calls and P._EARLY_SIGNAL.is_set()
        handler(sig, None)
        handler(sig, None)
        assert calls == [sig, sig]
    finally:
        P._EARLY_SIGNAL.clear()
        P._EARLY_HANDLERS.pop(sig, None)
        signal.signal(sig, signal.SIG_DFL)


def test_early_signal_becomes_the_next_guards_stop():
    sig = signal.SIGUSR2
    try:
        assert P.install_early_handler(signals=(sig,))
        signal.getsignal(sig)(sig, None)
        with PreemptionGuard(signals=(sig,)) as guard:
            assert guard.should_stop and not P._EARLY_SIGNAL.is_set()
        with PreemptionGuard(signals=(sig,)) as fresh:
            assert not fresh.should_stop
    finally:
        P._EARLY_SIGNAL.clear()
        P._EARLY_HANDLERS.pop(sig, None)
        signal.signal(sig, signal.SIG_DFL)


def test_stop_callbacks_run_once_and_a_broken_one_does_not_eat_the_stop(monkeypatch):
    seen = []
    monkeypatch.setattr(P, "_STOP_CALLBACKS", [])
    monkeypatch.setattr(P, "_escalate", lambda signum: None)
    P.register_stop_callback(lambda s: 1 / 0)
    P.register_stop_callback(seen.append)
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    guard._handle(signal.SIGUSR1, None)
    guard._handle(signal.SIGUSR1, None)
    assert guard.should_stop and seen == [signal.SIGUSR1]


def test_outermost_exit_restores_default_after_early_handler():
    sig = signal.SIGUSR2
    assert P.install_early_handler(signals=(sig,))
    with PreemptionGuard(signals=(sig,)):
        pass
    try:
        assert signal.getsignal(sig) is signal.SIG_DFL
    finally:
        signal.signal(sig, signal.SIG_DFL)
