"""The two contracts this port adds to its trace audit
(``analysis/trace_audit.py``), JAX's ``audit_multitenant`` and
``audit_region_front`` restated for graphs, on the CPU: clean on the real
tree, and each finds the violations JAX's seeds through a builder hook (a
spec-divergent tenant claiming the member's graph set, a slot model that
bakes its weights at capture, a region module importing torch, a predict
that reads the host under the live front).  The capture halves run on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import pytest

from deepfm_tpu_torch.analysis.trace_audit import (WAIVERS, audit_multitenant,
                                                   audit_region_front)
from deepfm_tpu_torch.serve.graphs import GraphedPredictor
from deepfm_tpu_torch.serve.pool.sharded import ShardedPredictor


def _slugs(findings):
    return {f.source for f in findings}


def test_both_contracts_hold_on_the_real_tree_and_are_not_waived():
    assert audit_multitenant("cpu") == []
    assert audit_region_front("cpu") == []
    assert "audit_multitenant" not in WAIVERS and "audit_region_front" not in WAIVERS


@pytest.mark.parametrize("field,value", [("embedding_size", 8), ("deep_layers", (16, 8))])
def test_a_spec_divergent_tenant_claiming_the_graph_set_is_found(field, value):
    findings = audit_multitenant("cpu", tenant_models=[{}, {field: value, "l2_reg": 0.5}])
    assert _slugs(findings) == {"multitenant-1-spec"}
    (f,) = findings
    assert f.rule == "trace-recompile" and f"diverging fields: ['{field}']" in f.message


def test_same_spec_tenants_with_neutral_overrides_pass():
    assert audit_multitenant("cpu", tenant_models=[{}, {"l2_reg": 0.5}, {}]) == []


def test_a_slot_model_that_bakes_its_weights_is_found():
    class Baked(ShardedPredictor):
        # the graphs would read a private copy: a swap's copy_ lands elsewhere
        def _leaves(self, slot):
            return {k: v.clone() for k, v in super()._leaves(slot).items()}

    findings = audit_multitenant(
        "cpu", predictor_builder=lambda c, sd, b, n: Baked(c, sd, buckets=b, tenants=n))
    assert "multitenant-baked" in _slugs(findings)


@pytest.mark.parametrize("source", ["import torch\n", "from torch.cuda import graph\n",
                                    "import os, torch.nn as nn\n"])
def test_a_region_module_importing_torch_is_found(source):
    findings = audit_region_front("cpu", region_sources={"region/front.py": source,
                                                         "region/ok.py": "import json\n"})
    assert _slugs(findings) == {"region-torch-import"}
    assert findings[0].message.startswith("region/front.py imports torch")


def test_a_predict_that_reads_the_host_under_the_front_is_found():
    class Reads(GraphedPredictor):
        def _forward(self, slot, ids, vals):
            # a routing decision keyed on a device value
            if ids.sum().item() < 0:
                ids = ids.clamp(0)
            return super()._forward(slot, ids, vals)

    findings = audit_region_front(
        "cpu", predict_builder=lambda c, sd, dev: Reads(c.model, sd, device=dev, buckets=(8,)))
    assert _slugs(findings) == {"region-predict-capture"}
    assert "host read item" in findings[0].message


def test_a_predict_that_is_not_deterministic_is_found():
    class Drifts(GraphedPredictor):
        calls = 0

        def predict_with(self, slot, feat_ids, feat_vals):
            Drifts.calls += 1
            return super().predict_with(slot, feat_ids, feat_vals) + Drifts.calls

    findings = audit_region_front(
        "cpu", predict_builder=lambda c, sd, dev: Drifts(c.model, sd, device=dev, buckets=(8,)))
    assert _slugs(findings) == {"region-predict-nondeterministic"}
