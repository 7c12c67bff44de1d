from .logging import MetricLogger  # noqa: F401
