"""State builders of tests/test_torch_collective_contracts.py's seeded
violations.  They run inside the spawned ranks of the trace audit's world
(deepfm_tpu_torch/analysis/collectives.py), so they live in a module that
imports no JAX."""


def replicated_moments(cfg, ctx):
    """A state that claims ZeRO windows for every parameter and holds its
    moments whole: the replicated optimizer with a plan (``n``, ``n``) a
    leaf.  Its step is the replicated update, which runs."""
    from deepfm_tpu_torch.parallel import spmd

    state = spmd.create_dp_train_state(
        cfg.with_overrides(optimizer={"zero_sharding": "off"}), ctx)
    params = dict(state.model.named_parameters())
    state.optimizer.plans = {name: (params[name].numel(), params[name].numel())
                             for name in state.optimizer.slots}
    return state
