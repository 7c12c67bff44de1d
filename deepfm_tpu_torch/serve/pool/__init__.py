"""The router-fronted shard-group serving pool: counterpart of
``deepfm_tpu/serve/pool``.

* :mod:`.sharded`: a member's row-sharded predict (fm_w/fm_v in ``mp``
  row shards on the member's card, the compact-table exchange, kernel B1
  on the assembled rows, one CUDA graph per (slot, bucket));
* :mod:`.worker`: one member (``GroupMember``): the sharded scorer, or a
  funnel scorer, behind HTTP plus the member half of the group-atomic swap
  (``/admin:stage|commit|rollback|abort``) and the generation-skew gate,
  for every tenant of a multi-tenant fleet (fleet/): three weight slots a
  tenant, one engine a tenant, one dispatch lock over the shared bucket
  buffers;
* :mod:`.router`: the front (consistent hashing, ejection and
  re-admission, generation pinning by (group, tenant), bounded retry,
  hedging, the shed gate, the traffic split, shadow scoring, the
  impression log);
* :mod:`.swap`: ``GroupSwapper``, the group-atomic hot swap of one
  (group, tenant) and the repair of a respawned member.

``python -m deepfm_tpu_torch.serve.pool`` (``__main__.py``) runs the whole
tier: a supervisor that never initialises CUDA, one member process a
group, the router and the swappers (one a group and tenant with
``--tenants``).  The process pool (``--workers N``) is
``serve/server.py serve_pool``.
"""

from ...fleet.registry import DEFAULT_TENANT

__all__ = ["DEFAULT_TENANT"]
