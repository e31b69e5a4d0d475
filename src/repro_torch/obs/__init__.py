"""Observability for the port.  Only the span tracer (``obs.trace``, copied
from ``repro.obs.trace``) is carried over: the pass manager records its
pass spans through it.  Export, drift reports and the metrics registry are
not ported yet."""
