"""Tracing / profiling hooks.

The reference has no in-code tracer — its methodology is external perf/VTune
plus compiler vectorization reports (SURVEY.md §5, reference README.md:19,
715-721). The equivalents here:

* `trace(logdir)` — context manager around `jax.profiler` producing an XLA
  trace viewable in TensorBoard/Perfetto (per-kernel device timing, the
  VTune analog);
* `annotate(name)` — TraceAnnotation for host-side phases;
* `device_memory_stats()` — live device-memory usage, the leak-check analog of the
  reference's CRT debug heap (rayweek1.cpp:932-934).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a device+host profile into `logdir`."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named host-side span that shows up in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats(device=None) -> Optional[dict]:
    """Per-device memory stats (bytes_in_use etc.), or None if the backend
    doesn't expose them."""
    device = device or jax.devices()[0]
    try:
        return device.memory_stats()
    except Exception:
        return None
