"""The port's shard decision matrix (deepfm_tpu_torch/data/sharding.py)
against the JAX package's over every combination of hosts, workers per
host, file or stream mode, ``pre_sharded`` and ``multi_path``: the same
decision, and across the fleet the shards tile the records (the platform's
own splits applied first, as ``tests/test_shard_matrix.py`` models them).
Then the rank's view: a launcher's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``
become the topology's local rank and workers per host, and so a
``multi_path`` rank's channel."""

import itertools

import pytest

from deepfm_tpu.data.sharding import WorkerTopology as JaxTopology
from deepfm_tpu.data.sharding import shard_plan as jax_shard_plan
from deepfm_tpu_torch.data.sharding import WorkerTopology, shard_plan, shard_records

TOPOLOGIES = [(1, 1), (1, 4), (2, 1), (2, 4), (4, 2), (3, 2)]
MODES = list(itertools.product([False, True], [False, True], [False, True]))


@pytest.mark.parametrize("stream_mode,pre_sharded,multi_path", MODES,
                         ids=[f"stream={s}-pre={p}-multi={m}" for s, p, m in MODES])
@pytest.mark.parametrize("num_hosts,wph", TOPOLOGIES,
                         ids=[f"{h}x{w}" for h, w in TOPOLOGIES])
def test_the_matrix_equals_jax_and_tiles_the_records(num_hosts, wph, stream_mode,
                                                     pre_sharded, multi_path):
    n_records = 840
    consumed = []
    for h, local in itertools.product(range(num_hosts), range(wph)):
        d = shard_plan(WorkerTopology(num_hosts, h, wph, local), stream_mode=stream_mode,
                       pre_sharded=pre_sharded, multi_path=multi_path)
        want = jax_shard_plan(JaxTopology(num_hosts, h, wph, local),
                              stream_mode=stream_mode, pre_sharded=pre_sharded,
                              multi_path=multi_path)
        assert (d.num_shards, d.shard_index, d.channel_index) == (
            want.num_shards, want.shard_index, want.channel_index)
        visible = list(range(n_records))
        if pre_sharded:  # each host's files hold a disjoint share
            visible = [i for i in visible if i % num_hosts == h]
        if stream_mode and multi_path:  # each local channel carries its paths
            visible = [v for j, v in enumerate(visible) if j % wph == d.channel_index]
        consumed += [visible[i] for i in shard_records(len(visible), d)]
    assert sorted(consumed) == list(range(n_records))


def test_a_launched_rank_reads_its_own_channel(monkeypatch):
    from deepfm_tpu_torch.data.pipeline import channel_path
    from deepfm_tpu_torch.parallel.mesh import DistContext

    ctx = DistContext(world_size=4, rank=3, local_rank=1, local_world_size=2,
                      device="cpu", group=None)
    topo = ctx.topology
    assert (topo.num_hosts, topo.host_rank, topo.workers_per_host,
            topo.local_rank) == (2, 1, 2, 1)
    d = shard_plan(topo, stream_mode=True, pre_sharded=False, multi_path=True)
    assert (d.num_shards, d.shard_index, d.channel_index) == (2, 1, 1)
    assert channel_path("/data/channels", "training", d) == "/data/channels/training-1"
