"""Utilities: a profiler trace, a throughput meter and NaN/Inf checks.

Counterpart of ``cswin_simam_unet_tpu/utils/``, whose ``cache.py`` (XLA's
persistent compile cache) has nothing to cache here.
"""

from .debug import DebugChecks, enable_debug_checks
from .profiling import ThroughputMeter, device_span_and_busy, start_profiler_server, trace

__all__ = ["DebugChecks", "ThroughputMeter", "device_span_and_busy", "enable_debug_checks",
           "start_profiler_server", "trace"]
