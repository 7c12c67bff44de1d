"""The port's trace-time contract audit (analysis/trace_audit.py) on the
CPU: the whole audit is clean on today's code, and each seeded regression
gives its finding (a step that rebinds a parameter instead of updating it
in place, a float64 optimizer slot, a float64 lazy moment, a paged step
whose hot cache is rebound).  The capture contracts run on the card
(``tests/test_torch_cuda.py``)."""

import contextlib
from types import SimpleNamespace

import pytest
import torch
from torch import nn

from deepfm_tpu_torch.analysis import Finding, run_trace_audit
from deepfm_tpu_torch.analysis.findings import RULES
from deepfm_tpu_torch.analysis.trace_audit import (WAIVERS, audit_buckets, audit_cfg,
                                                   audit_paged_step, audit_train_step,
                                                   check_in_place, distinct_batches,
                                                   state_tensors, _layout)
from deepfm_tpu_torch.train.step import create_train_state, graphed_train_step


def test_the_audit_is_clean_on_the_cpu():
    findings = run_trace_audit("cpu")
    assert findings == [], [f.render() for f in findings]


def test_a_step_that_rebinds_a_parameter_is_a_donation_finding():
    def rebinding(state, batch):
        metrics = graphed_train_step(state, batch)
        state.model.fm_b = nn.Parameter(state.model.fm_b.detach().clone())
        return metrics

    findings = audit_train_step("cpu", step=rebinding)
    assert [f.rule for f in findings] == ["trace-donation"]
    assert "model.fm_b" in findings[0].message and findings[0].hint


@pytest.mark.parametrize("lazy", [False, True], ids=["optimizer slot", "lazy moment"])
def test_a_float64_slot_is_a_dtype_finding(lazy):
    state = create_train_state(audit_cfg(lazy), "cpu")
    if lazy:
        state.lazy.m["fm_v"] = state.lazy.m["fm_v"].double()
        name = "lazy.m.fm_v"
    else:
        slots = state.optimizer.slots["mlp.out.kernel"]
        slots["nu"] = slots["nu"].double()
        name = "optimizer.mlp.out.kernel.nu"
    findings = audit_train_step("cpu", lazy=lazy, state=state)
    dtype = [f for f in findings if f.rule == "trace-dtype"]
    assert len(dtype) == 1 and name in dtype[0].message


def test_a_rebound_hot_cache_is_a_donation_finding(tmp_path):
    from deepfm_tpu_torch.tiered import TieredTrainer

    cfg = audit_cfg(lazy=True, fused_kernel="off", tiered_embeddings=True,
                    tiered_page_rows=64)
    bf = cfg.data.batch_size * cfg.model.field_size
    with TieredTrainer.from_resident_state(cfg, create_train_state(cfg, "cpu"),
                                           str(tmp_path / "cold"), capacity=bf,
                                           stage_rows=bf, host_rows=4 * bf) as tr:
        batches = distinct_batches(cfg, 2)
        tr.train_batch(batches[0])
        before = _layout(state_tensors(tr.state))
        tr.train_batch(batches[1])
        assert check_in_place(before, tr.state, "tiered", "paged step") == []
        tr.state.hot.rows["fm_v"] = tr.state.hot.rows["fm_v"].clone()
        findings = check_in_place(before, tr.state, "tiered", "paged step")
    assert [f.rule for f in findings] == ["trace-donation"]
    assert "hot.rows.fm_v" in findings[0].message


def test_the_paged_and_bucket_audits_are_clean_on_the_cpu():
    assert audit_paged_step("cpu") == []
    assert audit_buckets("cpu", buckets=(4, 16)) == []


def test_findings_render_and_fingerprint_stably():
    a = Finding("trace-dtype", "deepfm_tpu_torch/train/step.py", 0, 0, "x is float64",
                source="dense:f64:x")
    b = Finding("trace-dtype", "deepfm_tpu_torch/train/step.py", 0, 0, "other words",
                source="dense:f64:x")
    assert a.fingerprint == b.fingerprint and len(a.fingerprint) == 16
    assert a.render().startswith("deepfm_tpu_torch/train/step.py:0:0: [trace-dtype]")
    assert a.to_dict()["rule"] == "trace-dtype"
    assert {"trace-transfer", "trace-donation", "trace-dtype", "trace-parity",
            "trace-recompile"} <= set(RULES)


def test_the_grid_step_s_contracts_are_audited_not_waived(monkeypatch):
    """JAX's ``audit_spmd_exchange`` and ``audit_zero_update`` run on a
    record of the eager grid step (tests/test_torch_collective_contracts.py):
    ``WAIVERS`` names neither, and ``run_trace_audit`` runs both."""
    import deepfm_tpu_torch.analysis.trace_audit as ta

    assert not {"audit_spmd_exchange", "audit_zero_update"} & set(WAIVERS)
    assert set(WAIVERS) == {"online_trainer", "audit_elastic.host_round_trip"}
    for name in dir(ta):
        if name.startswith("audit_") and name != "audit_cfg":
            monkeypatch.setattr(ta, name, lambda *a, _n=name, **k: [Finding(
                "trace-collective", "deepfm_tpu_torch/parallel/spmd.py", 0, 0, _n,
                source=_n)])
    # no world is spawned: the stubs read none
    monkeypatch.setattr(ta, "start_grid_world", lambda device: contextlib.nullcontext(
        SimpleNamespace(results=dict)))
    ran = {f.source for f in run_trace_audit("cpu")}
    assert {"audit_spmd_exchange", "audit_zero_update"} <= ran


def test_the_state_tensors_cover_every_carried_tensor():
    state = create_train_state(audit_cfg(lazy=True, batch_norm=True), "cpu")
    graphed_train_step(state, distinct_batches(audit_cfg(), 1)[0])
    names = set(state_tensors(state))
    assert {"model.fm_w", "model.bn.layer_0.moving_mean", "lazy.m.fm_v", "lazy.v.fm_w",
            "optimizer.mlp.out.kernel.mu", "scalars"} <= names
    assert all(t.dtype == torch.float32 for t in state_tensors(state).values())


def test_audit_elastic_holds_the_plan_and_the_restore_window():
    """JAX's ``audit_elastic`` as the port restates it: clean on the port,
    and a planner that moves table bytes on a same-width shrink (or as
    many as a gather) is convicted; the host-round-trip clause is waived
    with its reason."""
    import dataclasses

    from deepfm_tpu_torch.analysis.trace_audit import audit_elastic
    from deepfm_tpu_torch.elastic.plan import plan_reshard

    assert audit_elastic("cpu") == []

    def wasteful(old, new, leaves):
        plan = plan_reshard(old, new, leaves)
        return dataclasses.replace(plan, moved_bytes=plan.naive_bytes + plan.kept_bytes)

    slugs = {f.source for f in audit_elastic("cpu", planner=wasteful)}
    assert slugs == {"elastic-2x4->1x4-plan-not-minimal", "elastic-2x4->1x4-shrink-moves-bytes",
                     "elastic-1x4->2x4-plan-not-minimal", "elastic-2x4->4x2-plan-not-minimal"}
    assert "memory-mapped" in WAIVERS["audit_elastic.host_round_trip"]
    assert "elastic trainer" in WAIVERS["online_trainer"]


@pytest.mark.parametrize("audit", ["train step", "paged step"])
def test_a_rebound_tensor_is_found_every_time_at_four_threads(audit, tmp_path):
    """The snapshot holds the tensors it names, so a tensor a step rebinds
    can never be allocated at a freed address and read as updated in
    place.  With only the addresses kept, the train step's audit missed the
    rebinding in about 6% of runs at four threads, and the paged state's
    check whenever the rebound cache took the freed cache's address."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        if audit == "train step":
            def rebinding(state, batch):
                metrics = graphed_train_step(state, batch)
                state.model.fm_b = nn.Parameter(state.model.fm_b.detach().clone())
                return metrics

            for _ in range(20):
                findings = audit_train_step("cpu", step=rebinding)
                assert [f.rule for f in findings] == ["trace-donation"]
                assert "model.fm_b" in findings[0].message
            return
        from deepfm_tpu_torch.tiered import TieredTrainer

        cfg = audit_cfg(lazy=True, fused_kernel="off", tiered_embeddings=True,
                        tiered_page_rows=64)
        bf = cfg.data.batch_size * cfg.model.field_size
        with TieredTrainer.from_resident_state(cfg, create_train_state(cfg, "cpu"),
                                               str(tmp_path / "cold"), capacity=bf,
                                               stage_rows=bf, host_rows=4 * bf) as tr:
            tr.train_batch(distinct_batches(cfg, 1)[0])
            for _ in range(20):
                before = _layout(state_tensors(tr.state))
                rows = tr.state.hot.rows
                kept = rows.pop("fm_v").clone()
                rows["fm_v"] = torch.empty_like(kept).copy_(kept)  # freed, then rebound
                findings = check_in_place(before, tr.state, "tiered", "paged step")
                assert [f.rule for f in findings] == ["trace-donation"]
                assert "hot.rows.fm_v" in findings[0].message
    finally:
        torch.set_num_threads(threads)
