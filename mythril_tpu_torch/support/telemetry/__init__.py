"""Span tracing, copied from ``mythril_tpu/support/telemetry`` as far as
the device screens use it: ``trace.span`` around each screen and
``trace.launch`` around each kernel launch."""

from . import spans as trace

__all__ = ["trace"]
