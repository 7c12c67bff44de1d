"""The 4-way data-shard decision matrix: a copy of
``deepfm_tpu/data/sharding.py`` (the port keeps its own, as it does of
every JAX-free module it uses).  The port's file mode reads the file-mode
rows of the matrix; stream mode waits for ROADMAP A6.

Reproduces the partitioning semantics of the reference
(README.md:87-92; code: hvd:127-149 for the Horovod path, ps:153-156 for the
PS path) with named concepts instead of nested ifs:

* ``pre_sharded``  — the platform already assigned each *host* a disjoint
  file subset (the reference's ``enable_s3_shard`` / S3 ShardedByS3Key).
* ``multi_path``   — streaming mode where each local worker has its own
  stream channel carrying a distinct path (hvd notebook cell 8).
* file vs stream   — File mode vs Pipe mode.

The output says: of ``num_shards`` ways, this worker takes ``shard_index``,
and (streaming only) reads channel ``channel_index``.  Invariant (tested):
across all workers the shards tile the record space exactly — no overlap,
no gaps.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WorkerTopology:
    num_hosts: int
    host_rank: int
    workers_per_host: int
    local_rank: int

    @property
    def world_size(self) -> int:
        return self.num_hosts * self.workers_per_host

    @property
    def global_rank(self) -> int:
        # rank ordering matches MPI/Horovod: host-major (hvd:134-149 relies on
        # rank // worker_per_host == host index)
        return self.host_rank * self.workers_per_host + self.local_rank


@dataclass(frozen=True)
class ShardDecision:
    """``dataset.shard(num_shards, shard_index)`` arguments + stream channel."""

    num_shards: int
    shard_index: int
    channel_index: int = 0  # streaming: which per-worker channel to read

    @property
    def is_noop(self) -> bool:
        return self.num_shards == 1


def shard_plan(
    topo: WorkerTopology,
    *,
    stream_mode: bool,
    pre_sharded: bool,
    multi_path: bool = False,
) -> ShardDecision:
    """The decision matrix (README.md:87-92, hvd:127-149).

    File mode (hvd:127-133):
      pre_sharded  -> shard(workers_per_host, local_rank)   # host files are disjoint
      else         -> shard(world_size, global_rank)
    Stream mode (hvd:134-149):
      multi_path and not pre_sharded and num_hosts > 1
                   -> shard(num_hosts, host_rank)           # channels split by worker,
                                                            # hosts see same paths
      multi_path and pre_sharded -> no shard                # fully pre-partitioned
      not multi_path and pre_sharded
                   -> shard(workers_per_host, local_rank)
      not multi_path and not pre_sharded
                   -> shard(world_size, global_rank)

    Stream channels: with multi_path each local worker reads its own channel
    (hvd:442-456 uses channel ``1 + local_rank``); otherwise all workers read
    channel 0.
    """
    channel = topo.local_rank if (stream_mode and multi_path) else 0
    if not stream_mode:
        if pre_sharded:
            return ShardDecision(topo.workers_per_host, topo.local_rank, channel)
        return ShardDecision(topo.world_size, topo.global_rank, channel)
    # streaming
    if multi_path and pre_sharded:
        return ShardDecision(1, 0, channel)
    if multi_path:
        if topo.num_hosts > 1:
            return ShardDecision(topo.num_hosts, topo.host_rank, channel)
        return ShardDecision(1, 0, channel)
    if pre_sharded:
        return ShardDecision(topo.workers_per_host, topo.local_rank, channel)
    return ShardDecision(topo.world_size, topo.global_rank, channel)


def shard_records(num_records: int, decision: ShardDecision) -> range:
    """Indices this worker owns under round-robin ``dataset.shard`` semantics
    (record i goes to shard i % num_shards)."""
    return range(decision.shard_index, num_records, decision.num_shards)
