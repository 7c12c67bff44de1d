"""Observability for the port's serving path: the metrics registry
(``GET /metrics``), request tracing (``GET /v1/trace/recent``) and the
flight recorder (``GET /v1/flight``).  Host-side only: nothing here runs
inside a CUDA graph or a kernel."""

from .flight import FlightRecorder, get_recorder, record
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, SlidingWindow
from .trace import SPAN_HEADER, TRACE_HEADER, TraceContext, Tracer, current_trace, span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SlidingWindow",
    "Tracer", "TraceContext", "current_trace", "span", "TRACE_HEADER",
    "SPAN_HEADER", "FlightRecorder", "get_recorder", "record",
]
