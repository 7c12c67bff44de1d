"""The grid step's two collective contracts (JAX ``audit_spmd_exchange`` and
``audit_zero_update``) as the port holds them: on a record of every
``torch.distributed`` call of one eager step on a spawned ``[2, 2]`` world
of gloo ranks (deepfm_tpu_torch/analysis/collectives.py), on the CPU.

* The recorder: backward collectives are recorded with the arm of their
  forward, the patches come off after an exception, an arm does nothing
  with no recorder, and ``collective_axis`` classifies the port's ``[2, 2]``
  and ``[2, 4]`` groups as JAX's does.
* One world (the audit's four jobs and a forced-overflow all-to-all step):
  both audits find nothing; a forced overflow keeps its dense traffic in
  the fallback arm; JAX's seeded violations are caught with JAX's rule and
  slug (a psum record through the all-to-all contract, a blind detector,
  dense traffic in the exchange arm, the full slot stream off its arm, a
  zero-off record through the ZeRO contract, a planned leaf's gradient
  all-reduced, no planned leaf); a second world builds replicated moments
  through ``context_builder``.
* JAX parity: for each case JAX's tests build, the port's ``(rule, slug)``
  set equals JAX's ``check_*`` on JAX's lowering at ``[2, 4]`` (the eight
  virtual devices of tests/conftest.py).
"""


import pytest
import torch
import torch.distributed as dist

from deepfm_tpu_torch.analysis import collectives
from deepfm_tpu_torch.analysis import trace_audit as ta
from deepfm_tpu_torch.parallel import branch, embedding
from deepfm_tpu_torch.parallel.mesh import _with_grid


def _keys(findings) -> set:
    return {(f.rule, f.source) for f in findings}


# ------------------------------------------------------------- the recorder

@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_the_recorder_stamps_backward_collectives_with_their_forward_s_arm(one_rank):
    axis = embedding.ModelAxis(one_rank, 1, 0)
    table = torch.randn(6, 3, requires_grad=True)
    ids = torch.tensor([0, 2, 2, 5])
    with collectives.CollectiveRecorder() as rec:
        with branch.arm("exchange.fallback"):
            rows = embedding._PsumRows.apply(ids, axis, "scatter", table)
        rows.sum().backward()  # outside the arm: the backward enters it again
        dist.all_reduce(torch.ones(2), op=dist.ReduceOp.MAX)
    assert [(e["op"], e["shapes"], e["arm"]) for e in rec.entries] == [
        ("all_reduce", [(4, 3)], "exchange.fallback"),
        ("all_reduce", [(4, 3)], "exchange.fallback"),
        ("all_reduce", [(2,)], None)]
    assert rec.entries[-1]["reduce_op"] == "MAX" and rec.entries[0]["reduce_op"] == "SUM"
    assert all(e["ranks"] == (0,) and e["dtype"] == "float32" for e in rec.entries)
    assert torch.equal(table.grad.sum(1), torch.tensor([3.0, 0, 6, 0, 0, 3]))


def test_the_recorder_restores_torch_distributed_after_an_exception():
    saved = {name: getattr(dist, name) for name in collectives.OPS}
    with pytest.raises(RuntimeError, match="seeded"):
        with collectives.CollectiveRecorder():
            assert dist.all_reduce is not saved["all_reduce"]
            raise RuntimeError("seeded")
    assert {name: getattr(dist, name) for name in collectives.OPS} == saved
    assert branch._watchers == 0


def test_an_arm_does_nothing_without_a_recorder():
    with branch.arm("exchange.fallback"):
        assert branch.current_arm() is None
    with collectives.CollectiveRecorder():
        with branch.arm("lazy.update_full"):
            assert branch.current_arm() == "lazy.update_full"
        assert branch.current_arm() is None


def _port_groups(dp: int, mp: int) -> dict:
    """Every group ``parallel/mesh.py _with_grid`` makes on a ``[dp, mp]``
    grid, as replica groups: the data groups, the model groups."""
    made = []

    class _Dist:
        @staticmethod
        def new_group(ranks):
            made.append(tuple(ranks))
            return tuple(ranks)

    import deepfm_tpu_torch.parallel.mesh as mesh

    real = mesh.dist
    mesh.dist = _Dist
    try:
        from deepfm_tpu_torch.parallel.mesh import DistContext

        _with_grid(DistContext(dp * mp, 0, 0, dp * mp, torch.device("cpu")), mp)
    finally:
        mesh.dist = real
    model = [g for g in made if len(g) == mp and g == tuple(range(g[0], g[0] + mp))]
    data = [g for g in made if g not in model]
    return {"data": data, "model": model}


@pytest.mark.parametrize("dp,mp", [(2, 2), (2, 4)])
def test_collective_axis_classifies_the_port_s_groups_as_jax_s(dp, mp):
    from deepfm_tpu.analysis.trace_audit import collective_axis as jax_axis

    groups = _port_groups(dp, mp)
    cases = {"data": groups["data"], "model": groups["model"],
             "world": [tuple(range(dp * mp))], "one data group": groups["data"][:1],
             "mixed": groups["data"][:1] + groups["model"][:1], "none": []}
    for name, g in cases.items():
        got = collectives.collective_axis([list(x) for x in g], dp, mp)
        assert got == jax_axis([list(x) for x in g], dp, mp), name
    assert collectives.collective_axis(groups["data"], dp, mp) == "data"
    assert collectives.collective_axis(groups["model"], dp, mp) == "model"


def test_merge_records_joins_the_ranks_groups_and_refuses_divergence():
    a = {"op": "all_reduce", "kind": "all_reduce", "shapes": [(3,)], "arm": None}
    merged = collectives.merge_records([[{**a, "ranks": (0, 2)}], [{**a, "ranks": (1, 3)}],
                                        [{**a, "ranks": (0, 2)}], [{**a, "ranks": (1, 3)}]])
    assert merged[0]["groups"] == [(0, 2), (1, 3)]
    with pytest.raises(ValueError, match="differs"):
        collectives.merge_records([[{**a, "ranks": (0,)}],
                                   [{**a, "arm": "exchange.fallback", "ranks": (1,)}]])


# ------------------------------------------------------------- the world

@pytest.fixture(scope="module")
def world():
    """The audit world with a forced-overflow all-to-all step beside its
    four jobs: a capacity of 5% of the lookups, so every step's buckets
    overflow and the exchange falls back."""
    overflow = ta.grid_job("overflow", model={"shard_exchange": "alltoall",
                                              "shard_exchange_capacity": 0.05})
    return ta.grid_world("cpu", extra=(overflow,))


def _dense(name: str, world: dict, *, lazy=False, **model):
    cfg = ta.grid_cfg(model, lazy=lazy)
    return ta.exchange_dense_shapes(cfg, world[name]["ranks"][0]["widths"], lazy=lazy)


def test_both_audits_find_nothing_on_the_real_steps(world):
    assert all("error" not in r for r in world.values()), world
    assert ta.audit_spmd_exchange("cpu", world=world) == []
    assert ta.audit_zero_update("cpu", world=world) == []
    assert all(r["seconds"] > 0 for r in world.values())


def test_the_world_ran_the_arms_the_contracts_read(world):
    arms = {name: {c["arm"] for c in r["record"]} for name, r in world.items()}
    assert arms["psum"] == {None}
    assert arms["alltoall"] == {None, "exchange.alltoall"}
    assert arms["lazy"] == {None, "exchange.alltoall", "lazy.update_dedup"}
    assert arms["overflow"] == {None, "exchange.fallback"}
    assert arms["zero"] == {None, "exchange.alltoall", "sync.stats", "zero.ineligible"}
    zero = world["zero"]["ranks"][0]
    assert zero["n_planned"] > 0
    # the ZeRO step's buffer without gradients (4 metrics and 5 flags), and
    # the one leaf without a window: fm_w's shard of 499 rows, odd over dp 2
    tagged = {c["arm"]: c["shapes"] for c in world["zero"]["record"] if c["arm"] in (
        "sync.stats", "zero.ineligible")}
    assert tagged == {"sync.stats": [(9,)], "zero.ineligible": [(499,)]}
    assert [name for name, leaf in zero["zero"].items() if not leaf["planned"]] == ["fm_w"]
    kinds = [c["kind"] for c in world["zero"]["record"]]
    assert kinds.count("reduce_scatter") == kinds.count("all_gather") == zero["n_planned"]


def test_a_forced_overflow_step_keeps_its_dense_traffic_in_the_fallback_arm(world):
    record = world["overflow"]["record"]
    dense = _dense("overflow", world, shard_exchange="alltoall")
    assert [c["arm"] for c in record if tuple(c["shapes"][0]) in dense] == [
        "exchange.fallback"] * 2  # forward and backward
    assert not any(c["kind"] == "all_to_all" for c in record)
    assert ta.check_exchange_collectives(record, dense, mode="alltoall") == []


def _psum_case(world):
    return world["psum"]["record"], _dense("psum", world, shard_exchange="psum")


def test_a_psum_record_through_the_alltoall_contract_is_caught(world):
    record, dense = _psum_case(world)
    viol = ta.check_exchange_collectives(record, dense, mode="alltoall")
    assert any("UNCONDITIONAL main line" in v.message for v in viol)
    assert any("WITHOUT any all_to_all" in v.message for v in viol)
    assert all(v.rule == "trace-collective" for v in viol)
    # the same record satisfies the psum contract (the detector sees the
    # dense all-reduce) ...
    assert ta.check_exchange_collectives(record, dense, mode="psum") == []
    # ... and a blind detector (wrong dense shapes) fails LOUDLY in psum
    # mode instead of passing alltoall vacuously
    blind = ta.check_exchange_collectives(record, {(1, 2, 3)}, mode="psum")
    assert blind and "detector" in blind[0].message


def _leaked(world):
    """The alltoall record with a dense all-reduce stamped into the arm that
    holds the all-to-all."""
    record = world["alltoall"]["record"]
    dense = _dense("alltoall", world, shard_exchange="alltoall")
    a2a = next(i for i, c in enumerate(record) if c["kind"] == "all_to_all")
    leak = {**record[a2a], "op": "all_reduce", "kind": "all_reduce",
            "shapes": [sorted(dense)[0]], "reduce_op": "SUM"}
    return record[:a2a + 1] + [leak] + record[a2a + 1:], dense


def test_dense_traffic_in_the_exchange_arm_is_caught(world):
    record, dense = _leaked(world)
    viol = ta.check_exchange_collectives(record, dense, mode="alltoall")
    assert [v.source for v in viol] == ["dense-alltoall-dense-in-exchange-arm"]


def test_the_lazy_step_s_full_slot_stream_off_its_arm_is_caught(world):
    """The lazy step's update_full gathers moved to the main line: JAX's
    forbidden all-gather of the occurrence stream outside the case."""
    cfg_shapes = _dense("lazy", world, lazy=True, shard_exchange="alltoall")
    record = world["lazy"]["record"]
    width = max(s[0] for s in cfg_shapes if len(s) == 1)
    moved = [{**c, "shapes": [(width,) + tuple(c["shapes"][0][1:])], "arm": None}
             if c["arm"] == "lazy.update_dedup" else c for c in record]
    viol = ta.check_exchange_collectives(moved, cfg_shapes, mode="alltoall", variant="lazy")
    assert [v.source for v in viol] == ["lazy-alltoall-dense-collective"]
    assert ta.check_exchange_collectives(record, cfg_shapes, mode="alltoall",
                                         variant="lazy") == []


def _zero_off(world):
    z = world["zero"]["ranks"][0]
    return ta.check_zero_collectives(world["psum"]["record"], dp=2, mp=2,
                                     n_sharded_leaves=z["n_planned"])


def test_a_zero_off_record_through_the_zero_contract_is_caught(world):
    viol = _zero_off(world)
    assert {v.source for v in viol} == {"zero-dense-allreduce", "zero-reduce-scatter-missing",
                                        "zero-allgather-missing"}
    assert all(v.rule == "trace-collective" for v in viol)


def test_a_planned_leaf_s_gradient_all_reduced_is_caught(world):
    """The ZeRO rule reads the arm a data-group all-reduce was issued in:
    the stats buffer (``sync.stats``) and an ineligible leaf's replicated
    update (``zero.ineligible``) pass, a planned leaf's gradient does not,
    even at the stats buffer's own size."""
    record = world["zero"]["record"]
    kw = dict(dp=2, mp=2, n_sharded_leaves=world["zero"]["ranks"][0]["n_planned"])
    assert ta.check_zero_collectives(record, **kw) == []
    rs = next(c for c in record if c["kind"] == "reduce_scatter" and c["shapes"][0][0] > 2)
    leak = {**rs, "op": "all_reduce", "kind": "all_reduce"}
    viol = ta.check_zero_collectives(record + [leak], **kw)
    assert [v.source for v in viol] == ["zero-dense-allreduce"]
    assert ta.check_zero_collectives(record + [{**leak, "arm": "zero.ineligible"}],
                                     **kw) == []
    stats = next(c for c in record if c["arm"] == "sync.stats")
    same_size = {**stats, "arm": None}  # a planned leaf of the buffer's 9 elements
    viol = ta.check_zero_collectives(record + [same_size], **kw)
    assert [v.source for v in viol] == ["zero-dense-allreduce"]


def _replicated_layout(world):
    """The ZeRO job's layout with every planned slot at the padded leaf's
    full size."""
    z = world["zero"]["ranks"][0]["zero"]
    return {name: {**leaf, "slots": {s: -(-leaf["numel"] // 2) * 2 for s in leaf["slots"]}}
            if leaf["planned"] else leaf for name, leaf in z.items()}


def test_no_planned_leaf_and_replicated_moments_are_caught(world):
    assert world["psum"]["ranks"][0]["zero"] is None
    assert [v.source for v in ta.check_zero_state_sharding(None, dp=2)] == [
        "zero-moments-unsharded"]
    assert [v.source for v in ta.check_zero_state_sharding(
        _replicated_layout(world), dp=2)] == ["zero-moments-replicated"]
    for rank in world["zero"]["ranks"]:
        assert ta.check_zero_state_sharding(rank["zero"], dp=2) == []


def test_replicated_moments_through_the_context_builder_are_caught(world):
    from _torch_collective_worker import replicated_moments

    viol = ta.audit_zero_update("cpu", context_builder=replicated_moments)
    assert "zero-moments-replicated" in {v.source for v in viol}
    assert {"zero-dense-allreduce", "zero-reduce-scatter-missing"} <= {v.source for v in viol}


# ------------------------------------------------------------- JAX parity

@pytest.fixture(scope="module")
def jax_lowerings():
    """JAX's lowerings of TestCollectiveContract and TestZeroUpdateContract
    (tests/test_analysis.py): the psum step and the zero-off step at
    [2, 4], and the zero-on context for the stripped-sharding case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deepfm_tpu.analysis.trace_audit import _audit_cfg
    from deepfm_tpu.core.config import MeshConfig
    from deepfm_tpu.parallel import (abstract_spmd_state, build_mesh, make_context,
                                     make_spmd_train_step)

    base = _audit_cfg().with_overrides(data={"batch_size": 128})
    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    f = base.model.field_size
    batch = {"feat_ids": jax.ShapeDtypeStruct((128, f), jnp.int32),
             "feat_vals": jax.ShapeDtypeStruct((128, f), jnp.float32),
             "label": jax.ShapeDtypeStruct((128,), jnp.float32)}

    def lowered(cfg):
        ctx = make_context(cfg, mesh)
        state = abstract_spmd_state(ctx)
        return ctx, state, make_spmd_train_step(ctx, donate=False).lower(
            state, batch).as_text()

    _, _, psum = lowered(base.with_overrides(model={"shard_exchange": "psum"}))
    rctx, rstate, replicated = lowered(base.with_overrides(optimizer={"zero_sharding": "off"}))
    zctx = make_context(base.with_overrides(optimizer={"zero_sharding": "on"}), mesh)
    stripped = jax.tree_util.tree_map(lambda sh: NamedSharding(mesh, P()),
                                      zctx.state_shardings)
    return {"psum": psum, "psum_dense": {(64, f, 32), (64, f)}, "replicated": replicated,
            "unsharded": (rctx.state_shardings.opt_state, rstate.opt_state),
            "stripped": (stripped.opt_state, abstract_spmd_state(zctx).opt_state)}


# a lax.cond whose exchange arm holds the all_to_all and a dense all-reduce
_JAX_LEAKED_ARM = "\n".join([
    "module {",
    "  func.func public @main(%arg0: tensor<64x8x16xf32>) -> tensor<64x8x16xf32> {",
    '    %1 = "stablehlo.case"(%i) ({',
    '      %2 = "stablehlo.all_to_all"(%arg0) : (tensor<4x2xi32>) -> tensor<4x2xi32>',
    '      %3 = "stablehlo.all_reduce"(%arg0) ({',
    "      ^bb0(%a: tensor<f32>, %b: tensor<f32>):",
    "        %s = stablehlo.add %a, %b : tensor<f32>",
    "        stablehlo.return %s : tensor<f32>",
    "      }) : (tensor<64x8x16xf32>) -> tensor<64x8x16xf32>",
    "      stablehlo.return %3 : tensor<64x8x16xf32>",
    "    }, {",
    "      stablehlo.return %arg0 : tensor<64x8x16xf32>",
    "    }) : (tensor<i32>) -> tensor<64x8x16xf32>",
    "    return %1 : tensor<64x8x16xf32>",
    "  }",
    "}"])

_PARITY = ("real-exchange", "real-zero", "psum-through-alltoall", "psum-contract",
           "blind-detector", "dense-in-exchange-arm", "zero-off", "moments-unsharded",
           "moments-replicated")


@pytest.mark.parametrize("case", _PARITY)
def test_the_port_s_rules_and_slugs_equal_jax_s(case, world, jax_lowerings):
    import deepfm_tpu.analysis.trace_audit as jt

    j = jax_lowerings
    if case == "real-exchange":
        mine, theirs = ta.audit_spmd_exchange("cpu", world=world), jt.audit_spmd_exchange()
    elif case == "real-zero":
        mine, theirs = ta.audit_zero_update("cpu", world=world), jt.audit_zero_update()
    elif case == "psum-through-alltoall":
        mine = ta.check_exchange_collectives(*_psum_case(world), mode="alltoall")
        theirs = jt.check_exchange_collectives(j["psum"], j["psum_dense"], mode="alltoall")
    elif case == "psum-contract":
        mine = ta.check_exchange_collectives(*_psum_case(world), mode="psum")
        theirs = jt.check_exchange_collectives(j["psum"], j["psum_dense"], mode="psum")
    elif case == "blind-detector":
        mine = ta.check_exchange_collectives(_psum_case(world)[0], {(1, 2, 3)}, mode="psum")
        theirs = jt.check_exchange_collectives(j["psum"], {(1, 2, 3)}, mode="psum")
    elif case == "dense-in-exchange-arm":
        mine = ta.check_exchange_collectives(*_leaked(world), mode="alltoall")
        theirs = jt.check_exchange_collectives(_JAX_LEAKED_ARM, {(64, 8, 16)},
                                               mode="alltoall")
    elif case == "zero-off":
        mine = _zero_off(world)
        theirs = jt.check_zero_collectives(j["replicated"], dp=2, mp=4, n_sharded_leaves=11)
    elif case == "moments-unsharded":
        mine = ta.check_zero_state_sharding(world["psum"]["ranks"][0]["zero"], dp=2)
        theirs = jt.check_zero_state_sharding(*j["unsharded"], dp=2)
    else:
        mine = ta.check_zero_state_sharding(_replicated_layout(world), dp=2)
        theirs = jt.check_zero_state_sharding(*j["stripped"], dp=2)
    assert _keys(mine) == _keys(theirs)
    assert case.startswith(("real", "psum-contract")) or _keys(mine)
