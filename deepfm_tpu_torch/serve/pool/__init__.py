"""The router-fronted shard-group serving pool: counterpart of
``deepfm_tpu/serve/pool``.

* :mod:`.sharded`: a member's row-sharded predict (fm_w/fm_v in ``mp``
  row shards on the member's card, the compact-table exchange, kernel B1
  on the assembled rows, one CUDA graph per (slot, bucket));
* :mod:`.worker`: one member (``GroupMember``): the sharded scorer, or a
  funnel scorer, behind HTTP plus the member half of the group-atomic swap
  (``/admin:stage|commit|rollback|abort``) and the generation-skew gate;
* :mod:`.router`: the front (consistent hashing, ejection and
  re-admission, generation pinning, bounded retry, hedging, the shed
  gate, the impression log);
* :mod:`.swap`: ``GroupSwapper``, the group-atomic hot swap and the repair
  of a respawned member.

``python -m deepfm_tpu_torch.serve.pool`` (``__main__.py``) runs the whole
tier: a supervisor that never initialises CUDA, one member process a
group, the router and the swappers.  The process pool (``--workers N``) is
``serve/server.py serve_pool``.  A member serves one tenant; multi-tenant
fleets are ROADMAP A18.
"""

# the one tenant a member serves (JAX fleet/registry.py DEFAULT_TENANT)
DEFAULT_TENANT = "default"
TENANTS_NOT_PORTED = ("multi-tenant members, shadows and the traffic split are not "
                      "ported yet (ROADMAP A18): a member serves one tenant, "
                      f"{DEFAULT_TENANT!r}")
