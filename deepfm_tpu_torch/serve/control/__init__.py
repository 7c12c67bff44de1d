"""The serving control plane of one process: the per-bucket dispatch cost
model and deadline-aware admission with the priority shed ladder.  The
pool's autoscaler, hedging and router gate are ROADMAP A14."""

from .admission import (AdmissionController, DeadlineExpiredError,  # noqa: F401
                        DeadlineRejectedError, ShedError)
from .cost import BucketCostModel  # noqa: F401
