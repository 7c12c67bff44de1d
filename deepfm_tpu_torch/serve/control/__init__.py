"""The serving control plane: the per-bucket dispatch cost model,
deadline-aware admission with the priority shed ladder (one process), and
the pool's host policy: the router's retry/hedge token budget and hedging
(hedge.py), its shadow shed gate (``LoadShedGate``) and the shard-group
autoscaler (autoscale.py).  None of it runs on the device."""

from .admission import (AdmissionController, DeadlineExpiredError,  # noqa: F401
                        DeadlineRejectedError, LoadShedGate, ShedError)
from .autoscale import AutoScaler  # noqa: F401
from .cost import BucketCostModel  # noqa: F401
from .hedge import HedgeController, TokenBudget  # noqa: F401
