"""Tracing and throughput: ``trace`` and ``ThroughputMeter``.

Counterpart of ``cswin_simam_unet_tpu/utils/profiling.py``.  ``trace``
records ``torch.profiler`` activity (the host's and, on a card, the
device's) and writes it where TensorBoard's profiler plugin reads it
(``tensorboard --logdir``); ``profile_serving.py`` reads the same profiler's
device events into a time breakdown.  JAX's ``start_profiler_server``, a
live-attach server for ``xprof``, has no counterpart in torch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed code: host activity, and the card's kernels and
    copies where CUDA is available.  On leaving, the trace is written under
    ``logdir`` as ``<host>_<pid>.<time>.pt.trace.json``; the profile is
    yielded (``key_averages()`` and the like)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the enclosed kernels end inside the trace


def device_span_and_busy(prof) -> tuple[float, float]:
    """(span, busy) in microseconds of the device activity that the
    profile ``prof`` recorded: from the first start to the last end, and
    the length of the union of the activities' intervals.  Raises where it
    recorded none."""
    intervals = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy, cur_start, cur_end = 0.0, intervals[0][0], intervals[0][1]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return max(end for _, end in intervals) - intervals[0][0], busy


def start_profiler_server(port: int = 9999):
    """Not ported, by design: JAX's live-attach ``xprof`` server
    (``jax.profiler.start_server``) has no torch counterpart."""
    raise NotImplementedError(
        "start_profiler_server is JAX's live-attach xprof server "
        "(jax.profiler.start_server), which torch does not have; record a trace "
        "with utils.trace(logdir) and open it in TensorBoard instead")


class ThroughputMeter:
    """Steps/s, images/s and images/s per card since the last ``reset``.
    ``n_chips`` defaults to the cards the run uses: the ranks of ``mesh``
    (one a card), else ``torch.cuda.device_count()``, and 1 without a card."""

    def __init__(self, n_chips: Optional[int] = None, mesh=None):
        if n_chips is None:
            n_chips = mesh.size if mesh is not None else torch.cuda.device_count()
        self.n_chips = max(int(n_chips), 1)
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._images = 0

    def update(self, batch_size: int) -> None:
        """Count one step of ``batch_size`` images (its global batch under a
        mesh).  Call it after the step's results are on the host, or the
        clock counts only what was enqueued."""
        self._steps += 1
        self._images += batch_size

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self._steps / max(self.elapsed, 1e-9)

    @property
    def images_per_sec(self) -> float:
        return self._images / max(self.elapsed, 1e-9)

    @property
    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec / self.n_chips

    def summary(self) -> str:
        return (f"{self.steps_per_sec:.2f} steps/s, "
                f"{self.images_per_sec:.1f} img/s "
                f"({self.images_per_sec_per_chip:.1f} img/s/chip)")
