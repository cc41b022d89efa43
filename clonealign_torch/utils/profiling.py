"""Profiling hooks (the reference has none; the ELBO trace in
``convergence_info``, ``ClonealignFit.timings`` and these helpers are the
observability surface); counterpart of ``clonealign_tpu/utils/profiling.py``."""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of host and CUDA activity into
    ``log_dir`` (a ``*.pt.trace.json`` file, viewable in TensorBoard or
    Perfetto); the profiler is yielded for ``key_averages()``.

    >>> with trace("clonealign-trace"):
    ...     fit = clonealign(Y, L)
    """
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


@contextlib.contextmanager
def timed(label: str = "", sink=print):
    """Wall-clock a block, waiting at exit for the work queued on the
    current CUDA device."""
    import torch

    t0 = time.perf_counter()
    try:
        yield
    finally:
        # flush any in-flight device work before reading the clock; with no
        # CUDA context made nothing can be in flight
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        sink(f"{label or 'block'}: {time.perf_counter() - t0:.3f}s")
